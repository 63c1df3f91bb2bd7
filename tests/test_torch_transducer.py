"""The port's transducer serving path against the JAX package on the CPU.

A tiny random transducer (the decode slice's 2-layer, 64 d encoder; LSTM
predictor 1 x 32; joint 48; vocab 64; CTC 0.1; the k2 simple projections;
a 1 + 1-block decoder) is exported with ``chunkformer_tpu.export`` and loaded
by both packages (C12: the port used to drop the predictor, joint and simple
projections and decode such an export with its CTC head). The embedding and
conv predictors and the HAT joint, which the JAX export does not write, go
across through ``state_dict_from_jax_params``.

The fixture's joint is shaped so that greedy decoding is not one token
everywhere: the encoder's biases are zero, the joint's encoder projection is
scaled by 4 and centred on the first WAV's mean encoder frame, its output
layer scaled by 3 and the blank logit raised by 1 (HAT: the token head
scaled by 3 and the blank head's bias lowered by 2.5), so blank wins on part
of the frames and the others emit 1 to 8 tokens of several kinds.

Tolerances: predictor and joint outputs 1e-5 (f32); frame tokens, token
sequences, text, timestamps, hypotheses and result files identical; beam
scores rtol 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.bin import recognize as jax_recognize
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models import transducer as jt
from chunkformer_tpu.models import transducer_search as jts
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.bin import recognize
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import load_state_dict, state_dict_from_jax_params
from chunkformer_tpu_torch.models import transducer as tt
from chunkformer_tpu_torch.models import transducer_search as tts

from .test_torch_api import TINY, _speechlike
from .test_torch_search import HYBRID, _table

V = TINY["output_dim"]
C, L, R = 8, 16, 16
BUDGET = 4  # seconds: 1.92 s steps with 2.56 s lookahead
RNNT = {**TINY, "model": "transducer", "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32, "hidden_size": 32,
                           "num_layers": 1, "embed_dropout": 0.0, "n_head": 2,
                           "history_size": 2},
        "joint_conf": {"join_dim": 48, "pred_output_size": 32},
        "decoder": "bitransformer", "decoder_conf": HYBRID["decoder_conf"],
        "model_conf": {"ctc_weight": 0.1, "enable_k2": True}}
ATOL = 1e-5


def _config(ptype="rnn", hat=False, **extra):
    d = {**RNNT, "predictor": ptype, "joint_conf": {**RNNT["joint_conf"], "hat_joint": hat},
         **extra}
    cfg = JaxConfig.from_dict(d)
    cfg.vocab_size = V
    return d, cfg


def _zero_biases(tree):
    return {k: (_zero_biases(v) if isinstance(v, dict)
                else np.zeros_like(v) if k in ("b", "bias") else v) for k, v in tree.items()}


def _params(ptype="rnn", hat=False, seed=0, cmvn=None):
    d, cfg = _config(ptype, hat)
    params = jax.tree.map(np.asarray, jt.init_transducer(jax.random.PRNGKey(seed), cfg, cmvn))
    return d, cfg, params


def _port(params, d, cmvn=False):
    cfg = ChunkFormerConfig.from_dict(d)
    cfg.vocab_size = V
    model = tt.TransducerModel(cfg, cmvn=cmvn)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return cfg, model.eval()


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The transducer export (RNN predictor, plain joint) and its HAT twin,
    three WAVs and a test list."""
    root = tmp_path_factory.mktemp("torch_transducer")
    rng = np.random.default_rng(0)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    wavs, rows = [], []
    for i, seconds in enumerate((6.1, 4.3, 2.2)):
        path = str(root / f"r{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        wavs.append(path)
        rows.append(f"utt{i}\t{path}\tt1 t2")
    test_list = root / "test.list"
    test_list.write_text("\n".join(rows) + "\n", encoding="utf-8")
    dirs = {}
    for hat in (False, True):
        d, cfg, params = _params("rnn", hat, cmvn=cmvn)
        params["encoder"] = _zero_biases(params["encoder"])
        jp = params["joint"]
        jp["enc_ffn"]["w"] = jp["enc_ffn"]["w"] * 4.0
        jm = JaxModel(cfg, params)
        feats = jm.extract_features(wavs[0])
        enc = np.asarray(jm.encode(feats[None], np.asarray([feats.shape[0]]))[0])[0]
        jp["enc_ffn"]["b"] = -(enc.mean(0) @ jp["enc_ffn"]["w"])
        if hat:
            jp["token_pred"]["w"] = jp["token_pred"]["w"] * 3.0
            jp["blank_pred"]["b"] = jp["blank_pred"]["b"] - 2.5
        else:
            jp["ffn_out"]["w"] = jp["ffn_out"]["w"] * 3.0
            jp["ffn_out"]["b"] = jp["ffn_out"]["b"] + np.eye(V, dtype=np.float32)[0]
        dirs[hat] = (export_model_dir(str(root / f"export_hat{int(hat)}"), d, params, _table()),
                     params)
    return dirs, wavs, str(test_list), root


@pytest.fixture(scope="module")
def models(exports):
    model_dir = exports[0][False][0]
    return (JaxModel.from_pretrained(model_dir),
            ChunkFormerModel.from_pretrained(model_dir, device="cpu"))


def test_rnnt_config_matches_jax():
    """examples/asr/rnnt/conf/chunkformer-rnnt-small.yaml: the same values
    in every field the two packages share (the enable_k2 schema move
    included)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples/asr/rnnt/conf/chunkformer-rnnt-small.yaml")
    got, want = ChunkFormerConfig.from_yaml(path), JaxConfig.from_yaml(path)
    for name in ("encoder_conf", "decoder_conf", "ctc_conf", "model_conf", "predictor_conf",
                 "joint_conf"):
        g, w = dataclasses.asdict(getattr(got, name)), dataclasses.asdict(getattr(want, name))
        assert {k: v for k, v in w.items() if k in g} == g, name
    assert (got.model, got.predictor, got.decoder) == ("transducer", "rnn", "bitransformer")
    assert got.model_conf.use_pruned_loss and got.model_conf.enable_k2


@pytest.mark.parametrize("hat", [False, True])
def test_transducer_export_loads_strictly(exports, hat):
    """C12: every tensor of the export (predictor, joint, simple projections,
    CTC, decoder) loads with strict=True and equals the JAX parameters."""
    model_dir, params = exports[0][hat]
    tm = ChunkFormerModel.from_pretrained(model_dir, device="cpu")
    assert isinstance(tm.model, tt.TransducerModel) and tm.is_transducer
    carried = state_dict_from_jax_params(params, tm.config)
    got = tm.model.state_dict()
    saved = load_state_dict(os.path.join(model_dir, "pytorch_model.bin"))
    assert saved.keys() == carried.keys()
    assert set(got) == set(carried)
    heads = [k for k in carried if k.startswith(("predictor.", "joint.", "simple_"))]
    assert len(heads) >= 10 and any(k.startswith("simple_am_proj") for k in heads)
    assert any(k.startswith("joint.blank_pred.2") for k in heads) == hat
    for k in carried:
        assert torch.equal(got[k], carried[k]), k


@pytest.mark.parametrize("ptype", ["rnn", "embedding", "conv"])
def test_predictor_matches_jax(ptype):
    """The predictor's forward over [B, U] tokens and six steps from the
    initial state (JAX's predictor_forward and predictor_step), each against
    JAX at 1e-5; the steps equal the forward."""
    d, cfg, params = _params(ptype, seed=1)
    tcfg, model = _port(params, d)
    tokens = np.random.default_rng(2).integers(0, V, size=(3, 6))
    want = jt.predictor_forward(jax.tree.map(jnp.asarray, params["predictor"]),
                                cfg.predictor_conf, jnp.asarray(tokens))
    with torch.no_grad():
        got = model.predictor(torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
        jstate = jt.predictor_init_state(cfg.predictor_conf, 3)
        tstate = tt.predictor_init_state(tcfg.predictor_conf, 3)
        for u in range(6):
            want_o, jstate = jt.predictor_step(jax.tree.map(jnp.asarray, params["predictor"]),
                                               cfg.predictor_conf, jnp.asarray(tokens[:, u]),
                                               jstate)
            got_o, tstate = model.predictor.step(torch.from_numpy(tokens[:, u]), tstate)
            np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL, rtol=ATOL)
            np.testing.assert_allclose(got_o.numpy(), got[:, u].numpy(), atol=ATOL, rtol=ATOL)
        for g, w in zip(jax.tree.leaves(tstate), jax.tree.leaves(jstate)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("hat", [False, True])
def test_joint_matches_jax(hat):
    """joint_forward on [B, T, E] x [B, U, P] and on the decode's 4-D inputs."""
    d, cfg, params = _params("rnn", hat, seed=3)
    _, model = _port(params, d)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(2, 5, 64)).astype(np.float32)
    pred = rng.normal(size=(2, 4, 32)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params["joint"])
    for e, p in ((enc, pred), (enc[:, :1, None], pred[:, None, :1])):
        want = jt.joint_forward(jp, cfg.joint_conf, jnp.asarray(e), jnp.asarray(p))
        with torch.no_grad():
            got = tt.joint_forward(model.joint, torch.from_numpy(e), torch.from_numpy(p))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("ptype,hat", [("rnn", False), ("embedding", False), ("conv", True)])
def test_greedy_matches_jax(ptype, hat):
    """transducer_greedy_search at n_steps 4 on a ragged batch: identical
    frame tokens (a mix of blank frames and emissions of several kinds);
    split in two calls with the carry threaded, the same tokens; and
    greedy_tokens_to_sequences."""
    d, cfg, params = _params(ptype, hat, seed=5)
    if hat:  # else blank wins everywhere
        params["joint"]["token_pred"]["w"] = params["joint"]["token_pred"]["w"] * 3.0
        params["joint"]["blank_pred"]["b"] = params["joint"]["blank_pred"]["b"] - 2.5
    tcfg, model = _port(params, d)
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(3, 14, 64)).astype(np.float32)
    lens = np.asarray([14, 9, 5])
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jt.transducer_greedy_search(jparams, cfg, jnp.asarray(enc),
                                                  jnp.asarray(lens), n_steps=4))
    with torch.no_grad():
        got = tt.transducer_greedy_search(model, tcfg, torch.from_numpy(enc), lens, n_steps=4)
        np.testing.assert_array_equal(got.numpy(), want)
        emitted = (want != 0).sum(-1)[np.arange(14)[None] < lens[:, None]]
        assert (emitted == 0).any() and (emitted > 0).any() and len(np.unique(want)) > 3
        k = 6
        a, carry = tt.transducer_greedy_search(model, tcfg, torch.from_numpy(enc[:, :k]),
                                               np.minimum(lens, k), 4, return_carry=True)
        b = tt.transducer_greedy_search(model, tcfg, torch.from_numpy(enc[:, k:]),
                                        np.maximum(lens - k, 0), 4, init_carry=carry)
        np.testing.assert_array_equal(torch.cat([a, b], 1).numpy(), want)
    assert tt.greedy_tokens_to_sequences(got, lens) == jt.greedy_tokens_to_sequences(want, lens)


@pytest.mark.parametrize("hat", [False, True])
def test_endless_decode_matches_jax(exports, hat):
    """C12: endless_decode at (8, 16, 16) with a 4 s budget (several
    macro-segments, the predictor carry crossing each boundary): the same
    RNN-T greedy segments and timestamps as chunkformer_tpu, and without a
    vocabulary the same token list."""
    model_dir, _ = exports[0][hat]
    wavs = exports[1]
    jm = JaxModel.from_pretrained(model_dir)
    tm = ChunkFormerModel.from_pretrained(model_dir, device="cpu")
    kw = dict(chunk_size=C, left_context_size=L, right_context_size=R,
              total_batch_duration=BUDGET)
    want = jm.endless_decode(wavs[0], **kw)
    assert want and tm.endless_decode(wavs[0], **kw) == want
    jm.char_dict = tm.char_dict = None
    want_tokens = jm.endless_decode(wavs[0], **kw)
    assert len(set(want_tokens)) > 2
    assert tm.endless_decode(wavs[0], **kw) == want_tokens
    # the fused carry equals one greedy pass over endless_encode's output
    feats = tm.extract_features(wavs[0])
    enc = tm.endless_encode(feats, C, L, R, BUDGET)
    frames = tm.endless_rnnt_tokens(feats, C, L, R, BUDGET)
    with torch.no_grad():
        whole = tt.transducer_greedy_search(tm.model, tm.config, enc[None], [enc.shape[0]], 8)
    np.testing.assert_array_equal(frames, whole[0].numpy())


def test_batch_decode_matches_jax(exports, models):
    """C12: batch_decode of three files in one batch: the same RNN-T greedy
    text and tokens as chunkformer_tpu."""
    jm, tm = models
    wavs = exports[1]
    kw = dict(chunk_size=C, left_context_size=L, right_context_size=R)
    want = jm.batch_decode(wavs, **kw)
    assert any(want) and tm.batch_decode(wavs, **kw) == want
    jm_dict, tm_dict = jm.char_dict, tm.char_dict
    jm.char_dict = tm.char_dict = None
    try:
        assert tm.batch_decode(wavs, **kw) == jm.batch_decode(wavs, **kw)
    finally:
        jm.char_dict, tm.char_dict = jm_dict, tm_dict


@pytest.mark.parametrize("fuse", [False, True])
def test_prefix_beam_and_rescoring_match_jax(models, fuse):
    """transducer_prefix_beam_search, beam 6, without and with CTC shallow
    fusion: the same hypotheses in the same order, scores rtol 1e-5; then
    transducer_attention_rescoring of those beams: the same tokens."""
    jm, tm = models
    rng = np.random.default_rng(7)
    enc = rng.normal(size=(12, 64)).astype(np.float32)
    ctc = (np.asarray(jax.nn.log_softmax(jnp.asarray(rng.normal(size=(12, V)).astype(
        np.float32)), -1)) if fuse else None)
    want = jts.transducer_prefix_beam_search(jm.params, jm.config, enc, 6,
                                             ctc_log_probs=ctc, ctc_weight=0.5)
    got = tts.transducer_prefix_beam_search(tm.model, tm.config, torch.from_numpy(enc), 6,
                                            ctc_log_probs=ctc, ctc_weight=0.5)
    assert [b.hyp for b in got] == [b.hyp for b in want] and len(got) == 6
    assert max(len(b.hyp) for b in got) > 2
    np.testing.assert_allclose([b.score for b in got], [b.score for b in want], rtol=1e-5)
    assert tts.transducer_attention_rescoring(tm.model, tm.config, got, torch.from_numpy(enc),
                                              0.3) == \
        jts.transducer_attention_rescoring(jm.params, jm.config, want, enc, 0.3)


def test_recognize_rnnt_modes_match_jax_cli(exports):
    """bin/recognize.py main(argv) with the three rnnt_* modes (beam 4,
    ctc_weight 0.3, batch 2: two padded batches) beside the JAX CLI at
    explicit chunk 0 (C8): the result files byte for byte."""
    dirs, _, test_list, root = exports
    model_dir = dirs[False][0]
    common = ["--model_checkpoint", model_dir, "--test_data", test_list, "--modes",
              "rnnt_greedy_search", "rnnt_beam_search", "rnnt_beam_attn_rescoring",
              "--beam_size", "4", "--batch_size", "2", "--chunk_size", "0",
              "--left_context_size", "0", "--right_context_size", "0"]
    want_dir, got_dir = str(root / "jax_rec"), str(root / "torch_rec")
    assert jax_recognize.main([*common, "--result_dir", want_dir]) == 0
    assert recognize.main([*common, "--result_dir", got_dir, "--device", "cpu"]) == 0
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == 6
    texts = []
    for name in names:
        with open(os.path.join(want_dir, name), encoding="utf-8") as f:
            want = f.read()
        with open(os.path.join(got_dir, name), encoding="utf-8") as f:
            assert f.read() == want, name
        texts.append(want)
    assert any(line.split("\t")[1] for t in texts if "\t" in t for line in t.splitlines())
