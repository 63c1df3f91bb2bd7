"""The port's search slice against the JAX package on the CPU: the hybrid
CTC/AED export (C6), ``decoder_step``, ``encode`` / ``endless_encode`` /
``ctc_logprobs``, the activations, and every search function.

A tiny random JAX model (2 layers, 64 d, 4 heads, vocab 64, a 1 + 1-block
bitransformer decoder) is exported with ``chunkformer_tpu.export`` and
loaded by both packages. Inputs are numpy from a seed and go to both sides.
Tokens, times and n-best lists must be identical, scores within rtol 1e-5,
log-probs and encoder outputs within f32 atol 1e-5.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.decode import batched_beam as jbb
from chunkformer_tpu.decode import search as js
from chunkformer_tpu.decode.context_graph import ContextGraph as JaxContextGraph
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.nn.decoder import decoder_step as jax_decoder_step
from chunkformer_tpu.nn.decoder import init_decoder_cache as jax_init_cache
from chunkformer_tpu.ops.ctc import ctc_forced_align as jax_forced_align
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import load_state_dict, state_dict_from_jax_params
from chunkformer_tpu_torch.decode import batched_beam as tbb
from chunkformer_tpu_torch.decode import search as ts
from chunkformer_tpu_torch.decode.context_graph import ContextGraph
from chunkformer_tpu_torch.nn.decoder import decoder_step, init_decoder_cache
from chunkformer_tpu_torch.ops.ctc import ctc_forced_align
from chunkformer_tpu_torch.ops.masks import mask_finished_preds, mask_finished_scores

from .test_torch_api import TINY, _speechlike

HYBRID = {**TINY, "decoder": "bitransformer",
          "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                           "r_num_blocks": 1, "dropout_rate": 0.0,
                           "positional_dropout_rate": 0.0},
          "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3}}
V = TINY["output_dim"]
ATOL = 1e-5


def _table():
    return {"<blank>": 0, **{f"t{i}▁" if i % 5 == 0 else f"t{i}": i for i in range(1, V)}}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The hybrid export, the CTC-only export of the same encoder and CTC
    weights, and two WAVs."""
    root = tmp_path_factory.mktemp("torch_search")
    rng = np.random.default_rng(1)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(1),
                                                     JaxConfig.from_dict(HYBRID), cmvn))
    hybrid = export_model_dir(str(root / "hybrid"), HYBRID, params, _table())
    ctc_only = export_model_dir(str(root / "ctc"), TINY,
                                {k: v for k, v in params.items() if k != "decoder"}, _table())
    wavs = []
    for i, seconds in enumerate((4.3, 2.1)):
        path = str(root / f"s{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        wavs.append(path)
    return hybrid, ctc_only, params, wavs


@pytest.fixture(scope="module")
def models(exports):
    hybrid = exports[0]
    return (JaxModel.from_pretrained(hybrid),
            ChunkFormerModel.from_pretrained(hybrid, device="cpu"))


def test_hybrid_export_loads_with_its_decoder(exports, models):
    """C6: the hybrid export loads with strict=True; its decoder weights
    equal the JAX parameters carried by ``state_dict_from_jax_params``; it
    decodes the same tokens as the CTC-only export of the same weights."""
    hybrid, ctc_only, params, wavs = exports
    tm = models[1]
    assert tm.model.decoder is not None and tm.model.decoder.right_decoder is not None
    carried = state_dict_from_jax_params(params, ChunkFormerConfig.from_dict(HYBRID))
    got = tm.model.state_dict()
    dec_keys = [k for k in carried if k.startswith("decoder.")]
    assert len(dec_keys) > 20 and set(dec_keys) == {k for k in got if k.startswith("decoder.")}
    for k in dec_keys:
        assert torch.equal(got[k], carried[k]), k
    assert load_state_dict(os.path.join(hybrid, "pytorch_model.bin")).keys() == carried.keys()
    plain = ChunkFormerModel.from_pretrained(ctc_only, device="cpu")
    assert plain.model.decoder is None
    kw = dict(chunk_size=8, left_context_size=16, right_context_size=16)
    assert tm.batch_decode(wavs, **kw) == plain.batch_decode(wavs, **kw)
    assert tm.endless_decode(wavs[0], total_batch_duration=4, **kw) == plain.endless_decode(
        wavs[0], total_batch_duration=4, **kw)


def _memory(rng, b, t, d=64):
    return rng.normal(size=(b, t, d)).astype(np.float32)


def test_decoder_step_matches_jax(models):
    """Six steps of the fixed-cache step on the same tokens: f32 log-probs
    within atol 1e-5 at every step."""
    jm, tm = models
    rng = np.random.default_rng(2)
    b, t, steps = 3, 9, 6
    mem = _memory(rng, b, t)
    lens = np.array([9, 5, 7])
    mask = np.arange(t)[None] < lens[:, None]
    toks = rng.integers(0, V, size=(steps, b))
    jcache = jax_init_cache(jm.config.decoder_conf, 1, b, steps + 1, 64)
    tcache = init_decoder_cache(1, b, steps + 1, 64, torch.float32, "cpu")
    for pos in range(steps):
        want, jcache = jax_decoder_step(jm.params["decoder"], jm.config.decoder_conf,
                                        jnp.asarray(mem), jnp.asarray(mask),
                                        jnp.asarray(toks[pos]), jnp.asarray(pos), jcache)
        got = decoder_step(tm.model.decoder, torch.from_numpy(mem), torch.from_numpy(mask),
                           torch.from_numpy(toks[pos]), pos, tcache)
        assert got.dtype == torch.float32 and got.shape == (b, V)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)


def test_finished_masks_match_jax():
    from chunkformer_tpu.ops import masks as jmasks

    rng = np.random.default_rng(3)
    scores = rng.normal(size=(4, 7)).astype(np.float32)
    preds = rng.integers(0, 7, size=(4, 3))
    fin = np.array([True, False, True, False])
    np.testing.assert_array_equal(
        mask_finished_scores(torch.from_numpy(scores), torch.from_numpy(fin), 6).numpy(),
        np.asarray(jmasks.mask_finished_scores(jnp.asarray(scores), jnp.asarray(fin), 6)))
    np.testing.assert_array_equal(
        mask_finished_preds(torch.from_numpy(preds), torch.from_numpy(fin), 6).numpy(),
        np.asarray(jmasks.mask_finished_preds(jnp.asarray(preds), jnp.asarray(fin), 6)))


def _feats(rng, b=3, t=150):
    xs = rng.normal(10.0, 2.0, size=(b, t, 80)).astype(np.float32)
    lens = np.array([t, t - 37, t - 90][:b], np.int32)
    return xs, lens


@pytest.mark.parametrize("chunk", [(0, 0, 0), (8, 16, 16)])
def test_encode_matches_jax(models, chunk):
    """``encode`` at full context and at (c, L, R) = (8, 16, 16) against JAX's
    XLA path and against its Pallas training kernel in interpret mode (as
    the JAX tests run it on the CPU): outputs at the valid frames and
    lengths; also ``ctc_logprobs``."""
    jm, tm = models
    xs, lens = _feats(np.random.default_rng(4))
    out, out_lens = tm.encode(xs, lens, *chunk)
    pallas = copy.copy(jm)
    pallas.config = copy.deepcopy(jm.config)
    pallas.config.encoder_conf.use_pallas_train = True
    pallas.config.encoder_conf.pallas_interpret = True
    pallas._jit_cache = {}
    for ref in (jm, pallas):
        want, want_lens = ref.encode(xs, lens, *chunk)
        np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
        valid = np.arange(out.shape[1])[None] < np.asarray(want_lens)[:, None]
        np.testing.assert_allclose(out.numpy()[valid], np.asarray(want)[valid], atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(tm.ctc_logprobs(out).numpy()[valid],
                               np.asarray(jm.ctc_logprobs(want))[valid], atol=ATOL, rtol=0)


def test_endless_encode_matches_jax(models, exports):
    """``endless_encode`` over several macro-segments: [T', D] float32
    within atol 1e-5; its argmax is ``endless_encode_tokens``."""
    jm, tm = models
    feats = tm.extract_features(exports[3][0])
    args = (8, 16, 16, 2)
    got = tm.endless_encode(feats, *args)
    want = jm.endless_encode(feats.numpy(), *args)
    assert got.dtype == torch.float32 and got.shape == want.shape and want.shape[0] > 40
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm.model.ctc.argmax(got).numpy(),
                                  tm.endless_encode_tokens(feats, *args))


@pytest.mark.parametrize("act", ["gelu", "hardtanh", "tanh", "selu"])
def test_activations_match_jax(act):
    """An encoder with each activation the JAX package adds (its FFNs), full
    and limited context, against JAX at f32 atol 1e-5."""
    conf = copy.deepcopy(TINY)
    conf["encoder_conf"]["activation_type"] = act
    jcfg = JaxConfig.from_dict(conf)
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(5), jcfg))
    jm = JaxModel(jcfg, params)
    tm = ChunkFormerModel(ChunkFormerConfig.from_dict(conf), state_dict_from_jax_params(
        params, ChunkFormerConfig.from_dict(conf)), device="cpu")
    xs, lens = _feats(np.random.default_rng(6), b=2, t=90)
    for chunk in ((0, 0, 0), (8, 16, 16)):
        out, out_lens = tm.encode(xs, lens, *chunk)
        want, _ = jm.encode(xs, lens, *chunk)
        valid = np.arange(out.shape[1])[None] < out_lens.numpy()[:, None]
        np.testing.assert_allclose(out.numpy()[valid], np.asarray(want)[valid], atol=ATOL,
                                   rtol=0)


def _log_probs(rng, b, t, v=V, scale=3.0):
    x = rng.normal(size=(b, t, v)).astype(np.float32) * scale
    return np.array(jax.nn.log_softmax(jnp.asarray(x), -1))


def _same_results(got, want, nbest=True, times=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.score, w.score, rtol=1e-5, atol=0)
        if times:
            assert g.times == w.times
        if nbest:
            assert g.nbest == w.nbest
            np.testing.assert_allclose(g.nbest_scores, w.nbest_scores, rtol=1e-5, atol=0)
            assert g.nbest_times == w.nbest_times


def test_ctc_greedy_search_matches_jax():
    rng = np.random.default_rng(7)
    logp = _log_probs(rng, 3, 40)
    lens = np.array([40, 31, 9])
    got, want = ts.ctc_greedy_search(logp, lens), js.ctc_greedy_search(logp, lens)
    _same_results(got, want, nbest=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.tokens_confidence, w.tokens_confidence, rtol=1e-6)


@pytest.mark.parametrize("with_context", [False, True])
def test_ctc_prefix_beam_search_matches_jax(with_context):
    """Host prefix beam with n-best and times, with and without a context
    graph of three hotwords (score 2.0)."""
    rng = np.random.default_rng(8)
    logp = _log_probs(rng, 2, 30, scale=2.0)
    lens = np.array([30, 22])
    phrases = [[3, 5], [7, 7, 2], [11]]
    jg = JaxContextGraph(phrases, 2.0) if with_context else None
    tg = ContextGraph(phrases, 2.0) if with_context else None
    got = ts.ctc_prefix_beam_search(logp, lens, 6, tg)
    want = js.ctc_prefix_beam_search(logp, lens, 6, jg)
    _same_results(got, want)
    assert len(got[0].nbest) == 6


def test_ctc_prefix_beam_search_batched_matches_jax():
    """The device-state batched beam (here on the CPU) against JAX's scan:
    tokens, lengths and scores of all K beams; and the results."""
    rng = np.random.default_rng(9)
    logp = _log_probs(rng, 3, 25, scale=2.0)
    lens = np.array([25, 17, 4], np.int32)
    got = tbb.ctc_prefix_beam_search_batched(torch.from_numpy(logp), torch.from_numpy(lens), 5)
    want = jbb.ctc_prefix_beam_search_batched(jnp.asarray(logp), jnp.asarray(lens), 5)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=0)
    _same_results(tbb.batched_beam_to_results(*got), jbb.batched_beam_to_results(*want),
                  times=False)


def _encoder_batch(rng, b=3, t=10):
    mem = _memory(rng, b, t)
    lens = np.array([t, t - 3, t - 6][:b])
    return mem, lens, np.arange(t)[None] < lens[:, None]


@pytest.mark.parametrize("search", ["attention_beam_search", "attention_beam_search_device"])
def test_attention_beam_search_matches_jax(models, search):
    """Both forms of the attention beam search (beam 4) on the same encoder
    outputs: identical tokens, scores within rtol 1e-5; the device form
    equals the host form."""
    jm, tm = models
    mem, lens, mask = _encoder_batch(np.random.default_rng(10))
    want = getattr(js, search)(jm.params, jm.config, jnp.asarray(mem), jnp.asarray(mask), 4)
    got = getattr(ts, search)(tm.model, tm.config, torch.from_numpy(mem),
                              torch.from_numpy(mask), 4)
    _same_results(got, want, nbest=False, times=False)
    if search.endswith("device"):
        host = ts.attention_beam_search(tm.model, tm.config, torch.from_numpy(mem),
                                        torch.from_numpy(mask), 4)
        _same_results(got, host, nbest=False, times=False)


@pytest.mark.parametrize("reverse_weight", [0.0, 0.3])
def test_attention_rescoring_matches_jax(models, reverse_weight):
    """Rescoring the host prefix beam's n-best with the left (and, at
    reverse_weight 0.3, the right) decoder, ctc_weight 0.5."""
    jm, tm = models
    rng = np.random.default_rng(11)
    mem, lens, _ = _encoder_batch(rng, t=12)
    logp = _log_probs(rng, 3, 12, scale=2.0)
    prefix = js.ctc_prefix_beam_search(logp, lens, 5)
    assert all(len(r.nbest) > 1 for r in prefix)
    want = js.attention_rescoring(jm.params, jm.config, prefix, jnp.asarray(mem), lens, 0.5,
                                  reverse_weight)
    got = ts.attention_rescoring(tm.model, tm.config, ts.ctc_prefix_beam_search(logp, lens, 5),
                                 torch.from_numpy(mem), lens, 0.5, reverse_weight)
    _same_results(got, want, nbest=False)


def test_ctc_forced_align_matches_jax():
    """Viterbi states of every frame, with frames past the input length,
    repeated labels (no skip across them) and a target per ~3 frames."""
    rng = np.random.default_rng(12)
    for t, t_len, targets in ((30, 30, [4, 9, 9, 2, 17, 5]), (40, 33, [1, 2, 3, 3, 3, 8]),
                              (12, 12, [7])):
        logp = _log_probs(rng, 1, t, scale=2.0)[0]
        got = ctc_forced_align(torch.from_numpy(logp), targets, t_len)
        want = jax_forced_align(jnp.asarray(logp), jnp.asarray(targets), jnp.asarray(t_len),
                                jnp.asarray(len(targets)))
        np.testing.assert_array_equal(got, np.asarray(want))
