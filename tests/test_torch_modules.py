"""The port's modules against their JAX counterparts on the CPU, at a tiny
width (2 layers, 64 d, 4 heads, dk 16, c 8, L = R = 16). Weights go from the
JAX parameter tree to the port through ``state_dict_from_jax_params``; inputs
are numpy arrays made from a seed. Integer arithmetic must agree exactly;
float outputs at f32 within 1e-5 (one module) to 2e-5 (the encoder), the
difference of two float32 summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.nn.attention import attention_parallel_chunk
from chunkformer_tpu.nn.convolution import conv_parallel_chunk
from chunkformer_tpu.nn.encoder import _embed, encoder_parallel_chunk
from chunkformer_tpu.nn.encoder_layer import encoder_layer_apply
from chunkformer_tpu.ops import chunk as jchunk
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params
from chunkformer_tpu_torch.models.asr import ASRModel
from chunkformer_tpu_torch.nn.embedding import rel_pos_slice
from chunkformer_tpu_torch.ops import chunk as tchunk

C, L, R = 8, 16, 16


def _config(norm):
    return {"encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                             "num_blocks": 2, "cnn_module_kernel": 15,
                             "cnn_module_norm": norm},
            "output_dim": 64}


@pytest.fixture(scope="module", params=["layer_norm", "batch_norm"])
def pair(request):
    """(JAX config, JAX params, port model) with the same random weights."""
    d = _config(request.param)
    jcfg = JaxConfig.from_dict(d)
    rng = np.random.default_rng(0)
    cmvn = (rng.normal(size=80).astype(np.float32), rng.uniform(0.5, 1.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(1), jcfg, cmvn))
    if request.param == "batch_norm":  # non-trivial running statistics
        norm = params["encoder"]["layers"]["conv"]["norm"]
        norm["mean"] = rng.normal(scale=0.1, size=norm["mean"].shape).astype(np.float32)
        norm["var"] = rng.uniform(0.5, 2.0, norm["var"].shape).astype(np.float32)
    model = ASRModel(ChunkFormerConfig.from_dict(d))
    model.load_state_dict(state_dict_from_jax_params(params, ChunkFormerConfig.from_dict(d)),
                          strict=True)
    return jcfg, params, model.eval()


def _packed(seed, lengths, offsets=None, capacity=None):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(t, 80)).astype(np.float32) for t in lengths]
    want = jchunk.pack_chunks(feats, lengths, C, offsets=offsets, capacity=capacity)
    got = tchunk.pack_chunks([torch.from_numpy(f) for f in feats], lengths, C,
                             offsets=offsets, capacity=capacity)
    return want, got


@pytest.mark.parametrize("lengths,offsets,capacity", [
    ([700], None, None), ([300, 90, 10, 519], [5, 0, 3, 7], 32), ([71], [2], 4)])
def test_pack_chunks_and_masks_match_jax(lengths, offsets, capacity):
    """Exact integer equality, capacity-padding rows included."""
    want, got = _packed(0, lengths, offsets, capacity)
    np.testing.assert_array_equal(got.xs.numpy(), want.xs)
    for name in ("chunk_idx", "offsets", "max_lens", "valid", "out_lens"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.n_chunks == want.n_chunks
    meta = [torch.from_numpy(a) for a in (got.chunk_idx, got.offsets, got.max_lens)]
    jmeta = [jnp.asarray(a) for a in (want.chunk_idx, want.offsets, want.max_lens)]
    np.testing.assert_array_equal(
        tchunk.parallel_chunk_att_mask(*meta, C, L, R).numpy(),
        np.asarray(jchunk.parallel_chunk_att_mask(*jmeta, C, L, R)))
    for lorder, right in ((7, R), (7, 0)):
        np.testing.assert_array_equal(
            tchunk.parallel_chunk_conv_mask(*meta, C, lorder, right).numpy(),
            np.asarray(jchunk.parallel_chunk_conv_mask(*jmeta, C, lorder, right)))


@pytest.mark.parametrize("start,capacity", [(0, 5), (128, 3), (192, 1)])
def test_device_pack_segment_matches_jax(start, capacity):
    feats = np.random.default_rng(1).normal(size=(700, 80)).astype(np.float32)
    feats[650:] = 0.0  # zero-padded past the audio end
    want = jchunk.device_pack_segment(jnp.asarray(feats), jnp.asarray(start, jnp.int32), C,
                                      capacity=capacity)
    got = tchunk.device_pack_segment(torch.from_numpy(feats), start, C, capacity=capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embed_matches_jax(pair):
    jcfg, params, model = pair
    xs = np.random.default_rng(2).normal(size=(3, 71, 80)).astype(np.float32)
    want = _embed(params["encoder"], jcfg.encoder_conf, jnp.asarray(xs))
    with torch.no_grad():
        got = model.encoder.embed_features(torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _layer_inputs(seed, n, d=64, heads=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, C, d)).astype(np.float32)
    att_cache = rng.normal(size=(L, heads, 2 * d // heads)).astype(np.float32)
    cnn_cache = rng.normal(size=(d, 7)).astype(np.float32)
    ci = np.arange(n, dtype=np.int32)
    off = np.full(n, 4, np.int32)
    ml = np.full(n, n * C - 3, np.int32)
    return x, att_cache, cnn_cache, ci, off, ml


def test_conv_parallel_chunk_matches_jax(pair):
    """Non-zero cache and trunc: outputs and new cache."""
    jcfg, params, model = pair
    x, _, cnn_cache, ci, off, ml = _layer_inputs(3, 6)
    trunc = 3 * C
    lp = jax.tree.map(lambda a: a[0], params["encoder"]["layers"])
    conv_mask = jchunk.parallel_chunk_conv_mask(jnp.asarray(ci), jnp.asarray(off),
                                                jnp.asarray(ml), C, 7, R)[:, 0:1, :]
    want, want_cache = conv_parallel_chunk(
        lp["conv"], jnp.asarray(x), conv_mask, jnp.asarray(cnn_cache), 15,
        jcfg.encoder_conf.cnn_module_norm == "layer_norm", trunc)
    with torch.no_grad():
        got, got_cache = model.encoder.encoders[0].conv_module.parallel_chunk(
            torch.from_numpy(x), torch.from_numpy(np.array(conv_mask)),
            torch.from_numpy(cnn_cache), trunc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cache.numpy(), np.asarray(want_cache), atol=1e-5, rtol=1e-5)


def test_encoder_layer_matches_jax(pair):
    """One Conformer block with non-zero caches: output and both new caches."""
    jcfg, params, model = pair
    cfg = jcfg.encoder_conf
    x, att_cache, cnn_cache, ci, off, ml = _layer_inputs(4, 6)
    trunc = 2 * C
    lp = jax.tree.map(lambda a: a[1], params["encoder"]["layers"])
    pos = rel_pos_slice(64, C, L, R)
    jci, joff, jml = map(jnp.asarray, (ci, off, ml))
    att_mask = jchunk.parallel_chunk_att_mask(jci, joff, jml, C, L, R)
    conv_mask = jchunk.parallel_chunk_conv_mask(jci, joff, jml, C, 7, R)[:, 0:1, :]
    want, want_att, want_cnn = encoder_layer_apply(
        lp, jnp.asarray(x),
        lambda h: attention_parallel_chunk(lp["self_attn"], h, jnp.asarray(pos), att_mask,
                                           jnp.asarray(att_cache), L, R, trunc, 4),
        lambda h: conv_parallel_chunk(lp["conv"], h, conv_mask, jnp.asarray(cnn_cache), 15,
                                      cfg.cnn_module_norm == "layer_norm", trunc))
    t = torch.from_numpy
    with torch.no_grad():
        got, got_att, got_cnn = model.encoder.encoders[1].parallel_chunk(
            t(x), t(pos), t(ci), t(off), t(ml), t(np.array(conv_mask)), t(att_cache),
            t(cnn_cache), L, R, trunc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cnn.numpy(), np.asarray(want_cnn), atol=1e-5, rtol=1e-5)


def test_encoder_parallel_chunk_matches_jax_pallas(pair):
    """Whole encoder against the JAX encoder on its Pallas attention (interpret
    mode), segment-style: non-zero caches, offsets, trunc and padding rows.
    Outputs and both caches at f32."""
    jcfg, params, model = pair
    want_p, got_p = _packed(5, [700], offsets=[6], capacity=16)
    rng = np.random.default_rng(6)
    att = rng.normal(size=(2, L, 4, 32)).astype(np.float32)
    cnn = rng.normal(size=(2, 64, 7)).astype(np.float32)
    trunc = 6 * C
    want, want_att, want_cnn = encoder_parallel_chunk(
        params["encoder"], jcfg.encoder_conf, jnp.asarray(want_p.xs),
        jnp.asarray(want_p.chunk_idx), jnp.asarray(want_p.offsets),
        jnp.asarray(want_p.max_lens), C, L, R, jnp.asarray(att), jnp.asarray(cnn), trunc,
        use_pallas=True, pallas_interpret=True)
    t = torch.from_numpy
    with torch.no_grad():
        got, got_att, got_cnn = model.encoder.parallel_chunk(
            got_p.xs, t(got_p.chunk_idx), t(got_p.offsets), t(got_p.max_lens), C, L, R,
            t(att), t(cnn), trunc)
    n = sum(want_p.n_chunks)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cnn.numpy(), np.asarray(want_cnn), atol=2e-5, rtol=1e-5)
