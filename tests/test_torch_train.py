"""The port's training path against the JAX package on the CPU, at a tiny
size: encoder 2 layers, 64 d, 4 heads (dk 16), FFN 128, conv kernel 15;
bitransformer decoder 1 + 1 blocks; vocab 40; (c, L, R) = (8, 16, 16);
dropout 0; f32. Weights go from the JAX parameter tree to the port through
``state_dict_from_jax_params``; inputs are numpy arrays from a seed.

Tolerances (float32 summation-order differences): one module 1e-5, the
encoder 2e-5, label smoothing 1e-6; the whole step: metrics rtol 1e-5,
gradients atol 1e-4 rtol 1e-4 (compared by name through the same
``convert.py`` map applied to the JAX gradient tree), parameters after the
adamw update atol 1e-6 where |g| > 1e-5 and within 2 lr elsewhere (Adam's
first update is about lr * sign(g), so tiny gradients may flip it).
The JAX step runs the Pallas training attention in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.nn.attention import attention_chunked_train
from chunkformer_tpu.nn.convolution import conv_full, init_conv_module
from chunkformer_tpu.nn.decoder import decoder_forward
from chunkformer_tpu.nn.embedding import rel_pos_slice
from chunkformer_tpu.nn.encoder import encoder_forward
from chunkformer_tpu.nn.encoder import limited_context_selection as jax_selection
from chunkformer_tpu.nn.encoder_layer import encoder_layer_apply
from chunkformer_tpu.ops import common as jcommon
from chunkformer_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from chunkformer_tpu.ops.masks import make_non_pad_mask
from chunkformer_tpu.train.losses import label_smoothing_loss as jax_lsm
from chunkformer_tpu.train.optim import build_optimizer as jax_build_optimizer
from chunkformer_tpu.train.train_step import create_train_state, make_train_step as jax_step
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params
from chunkformer_tpu_torch.models.asr import ASRModel
from chunkformer_tpu_torch.nn.convolution import ConvolutionModule
from chunkformer_tpu_torch.nn.encoder import limited_context_selection
from chunkformer_tpu_torch.ops import common as tcommon
from chunkformer_tpu_torch.ops import chunk_attention_train as cat
from chunkformer_tpu_torch.ops.ctc import ctc_loss
from chunkformer_tpu_torch.train.losses import label_smoothing_loss
from chunkformer_tpu_torch.train.optim import build_optimizer
from chunkformer_tpu_torch.train.train_step import make_eval_step, make_train_step

C, L, R = 8, 16, 16
VOCAB = 40


def _config(remat="dots", norm="layer_norm"):
    return {
        "model": "asr_model",
        "encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                         "num_blocks": 2, "cnn_module_kernel": 15, "cnn_module_norm": norm,
                         "dynamic_conv": True, "gradient_checkpointing": True,
                         "remat_policy": remat, "dropout_rate": 0.0,
                         "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0},
        "decoder": "bitransformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                         "r_num_blocks": 1, "dropout_rate": 0.0,
                         "positional_dropout_rate": 0.0},
        "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
        "output_dim": VOCAB,
    }


def _jax_cfg(d, pallas=True):
    d = {**d, "encoder_conf": {**d["encoder_conf"], "use_pallas_train": pallas,
                               "pallas_interpret": True}}
    return JaxConfig.from_dict(d)


def _port(params, d):
    cfg = ChunkFormerConfig.from_dict(d)
    model = ASRModel(cfg, cmvn=False)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return cfg, model


@pytest.fixture(scope="module")
def pair():
    d = _config()
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(1), _jax_cfg(d)))
    cfg, model = _port(params, d)
    return d, params, cfg, model


def _batch(seed, b=2, t=120, lens=(120, 77), u=6, tlens=(6, 4)):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 80)).astype(np.float32)
    tgts = rng.integers(1, VOCAB - 2, size=(b, u)).astype(np.int32)
    tlens = np.asarray(tlens, np.int32)
    tgts[np.arange(u)[None, :] >= tlens[:, None]] = -1
    return feats, np.asarray(lens, np.int32), tgts, tlens


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("norm,chunk,train", [
    ("layer_norm", 0, True), ("layer_norm", C, True),
    ("batch_norm", C, True), ("batch_norm", 0, False)])
def test_conv_full_matches_jax(norm, chunk, train):
    """Both branches (full context; dynamic_conv chunks with real left
    context and zero right pad) and both norms, with the new batch-norm
    statistics in train mode."""
    p = jax.tree.map(np.asarray, init_conv_module(jax.random.PRNGKey(2), 64, 15, norm))
    rng = np.random.default_rng(3)
    if norm == "batch_norm":
        p["norm"]["mean"] = rng.normal(scale=0.1, size=64).astype(np.float32)
        p["norm"]["var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    x = rng.normal(size=(3, 45, 64)).astype(np.float32)
    lens = np.asarray([45, 30, 7], np.int32)
    mask = np.arange(45)[None, :] < lens[:, None]
    want, want_stats = conv_full(p, jnp.asarray(x), jnp.asarray(mask), 15,
                                 norm == "layer_norm", chunk_size=chunk, train=train)
    m = ConvolutionModule(64, 15, norm)
    sd = {"pointwise_conv1.weight": p["pw1"]["w"], "pointwise_conv1.bias": p["pw1"]["b"],
          "depthwise_conv.weight": p["dw"]["w"], "depthwise_conv.bias": p["dw"]["b"],
          "pointwise_conv2.weight": p["pw2"]["w"], "pointwise_conv2.bias": p["pw2"]["b"],
          "norm.weight": p["norm"]["scale"], "norm.bias": p["norm"]["bias"]}
    if norm == "batch_norm":
        sd.update({"norm.running_mean": p["norm"]["mean"], "norm.running_var": p["norm"]["var"],
                   "norm.num_batches_tracked": np.asarray(0)})
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got, stats = m.full(*_t(x, mask), chunk_size=chunk, train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert (stats is None) == (want_stats is None)
    if stats is not None:
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(want_stats[k]), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("streaming", [False, True])
def test_limited_context_selection_matches_jax(streaming):
    """Same (c, L, R) draws from the same random.Random seed; (0, 0, 0) without lists."""
    import random

    lists = {"dynamic_chunk_sizes": [16, 32, 64] if streaming else [-1, 16, 32, 64],
             "dynamic_left_context_sizes": [32, 64],
             "dynamic_right_context_sizes": [0, 8, 16], "streaming": streaming}
    jcfg = JaxConfig.from_dict({"encoder_conf": lists}).encoder_conf
    cfg = ChunkFormerConfig.from_dict({"encoder_conf": lists}).encoder_conf
    want, got = random.Random(7), random.Random(7)
    draws = [limited_context_selection(cfg, got) for _ in range(20)]
    assert draws == [jax_selection(jcfg, want) for _ in range(20)]
    assert any(d[0] > 0 for d in draws) and limited_context_selection(
        ChunkFormerConfig.from_dict({}).encoder_conf) == (0, 0, 0)


def test_encoder_layer_train_matches_jax(pair):
    """One block in train mode over limited-context attention and the
    dynamic_conv branch (dropout 0, batch-statistics norms)."""
    d, params, cfg, model = pair
    lp = jax.tree.map(lambda a: a[1], params["encoder"]["layers"])
    x = np.random.default_rng(4).normal(size=(2, 37, 64)).astype(np.float32)
    lens = np.asarray([37, 20], np.int32)
    mask = make_non_pad_mask(jnp.asarray(lens), 37)
    pos = rel_pos_slice(64, C, L, R, 5000)
    want, _, _ = jax.jit(lambda lp, x: encoder_layer_apply(
        lp, x,
        lambda h: (attention_chunked_train(lp["self_attn"], h, jnp.asarray(pos), mask, C, L, R,
                                           4), None),
        lambda h: conv_full(lp["conv"], h, mask, 15, True, chunk_size=C, train=True),
        train=True))(lp, jnp.asarray(x))
    layer = model.encoder.encoders[1]
    xt, lt, pt, mt = _t(x, lens, pos, np.asarray(mask))
    with torch.no_grad():
        got = layer.forward_train(
            xt, lambda h: layer.self_attn.chunked_train(h, pt, lt, C, L, R),
            lambda h: layer.conv_module.full(h, mt, C, train=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ctx", [(C, L, R), (0, 0, 0)])
def test_encoder_forward_matches_jax(pair, ctx):
    """encoder_forward at (c, L, R) through the training attention (JAX: its
    Pallas kernels in interpret mode) and at full context; output and mask."""
    d, params, cfg, model = pair
    feats, lens, _, _ = _batch(5, b=3, t=99, lens=(99, 61, 40), tlens=(6, 4, 2))
    want, want_mask = jax.jit(lambda p, f, fl: encoder_forward(
        p, _jax_cfg(d).encoder_conf, f, fl, *ctx, train=True))(
            params["encoder"], jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got, mask = model.encoder.forward_train(*_t(feats, lens), *ctx, train=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_decoder_forward_matches_jax(pair):
    """Both directions of the bitransformer decoder."""
    d, params, cfg, model = pair
    rng = np.random.default_rng(6)
    memory = rng.normal(size=(2, 15, 64)).astype(np.float32)
    mem_mask = np.arange(15)[None, :] < np.asarray([15, 9])[:, None]
    _, _, tgts, tlens = _batch(7)
    ys_in, _ = jcommon.add_sos_eos(jnp.asarray(tgts), jnp.asarray(tlens), VOCAB - 1, VOCAB - 1)
    r_in, _ = jcommon.add_sos_eos(jcommon.reverse_pad_list(jnp.asarray(tgts), jnp.asarray(tlens)),
                                  jnp.asarray(tlens), VOCAB - 1, VOCAB - 1)
    want_l, want_r = decoder_forward(params["decoder"], _jax_cfg(d).decoder_conf,
                                     jnp.asarray(memory), jnp.asarray(mem_mask), ys_in,
                                     jnp.asarray(tlens) + 1, r_in, 0.3)
    tt, tl = _t(tgts, tlens)
    got_in, _ = tcommon.add_sos_eos(tt, tl, VOCAB - 1, VOCAB - 1)
    got_r_in, _ = tcommon.add_sos_eos(tcommon.reverse_pad_list(tt, tl), tl, VOCAB - 1,
                                      VOCAB - 1)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(ys_in))
    np.testing.assert_array_equal(got_r_in.numpy(), np.asarray(r_in))
    with torch.no_grad():
        got_l, got_r = model.decoder(*_t(memory, mem_mask), got_in, tl + 1, got_r_in, 0.3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5, rtol=1e-5)


def test_ctc_loss_matches_jax():
    """Values, and gradients with respect to the logits through the
    log-softmax; the third utterance has more labels than frames, which
    zero_infinity turns into a loss of 0 and no gradient."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 20, 12)).astype(np.float32)
    in_lens = np.asarray([20, 14, 3], np.int32)
    tgts = rng.integers(1, 12, size=(3, 6)).astype(np.int32)
    tgts[0, 2] = tgts[0, 3]                          # a repeated label
    t_lens = np.asarray([6, 3, 6], np.int32)

    def f(lg):
        return jax_ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(in_lens), jnp.asarray(tgts),
                            jnp.asarray(t_lens))

    want = f(jnp.asarray(logits))
    want_g = jax.grad(lambda lg: (f(lg) * jnp.arange(1.0, 4.0)).sum())(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(torch.log_softmax(lt, -1), *_t(in_lens, tgts, t_lens))
    (got * torch.arange(1.0, 4.0)).sum().backward()
    assert float(want[2]) == 0.0 and float(got[2].detach()) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), atol=1e-5)
    assert not lt.grad[2].any()


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(normalize_length):
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 7, VOCAB)).astype(np.float32)
    tgt = rng.integers(0, VOCAB, size=(3, 7)).astype(np.int32)
    tgt[1, 4:] = -1
    want = jax_lsm(jnp.asarray(logits), jnp.asarray(tgt), 0.1, normalize_length=normalize_length)
    got = label_smoothing_loss(*_t(logits, tgt), 0.1, normalize_length=normalize_length)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _grads_by_name(model, jax_grads, cfg):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads), cfg)
    return [(name, p.grad, want[name]) for name, p in model.named_parameters()]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(pair, accum):
    """One make_train_step step (adamw, grad clip 5, warmup 2 steps) against
    JAX's with the Pallas training attention in interpret mode: metrics,
    gradients by name, and the parameters after the update."""
    d, params, _, _ = pair
    jcfg = _jax_cfg(d)
    feats, lens, tgts, tlens = _batch(12, b=4, lens=(120, 77, 101, 64), tlens=(6, 4, 5, 3))

    opt, schedule = jax_build_optimizer("adamw", {"lr": 1e-3}, "warmuplr", {"warmup_steps": 2})
    step = jax.jit(jax_step(jcfg, opt, chunk_cfg=(C, L, R), accum_steps=accum))
    state, want_m = step(create_train_state(params, opt), *map(jnp.asarray, (
        feats, lens, tgts, tlens)), jax.random.PRNGKey(0))

    def loss(p, f, fl, t, tl):
        from chunkformer_tpu.train.losses import asr_model_loss
        return asr_model_loss(p, jcfg, f, fl, t, tl, C, L, R, train=True)["loss"]

    grad = jax.jit(jax.grad(loss))
    parts = [grad(params, *(jnp.asarray(a[i * 4 // accum:(i + 1) * 4 // accum])
                            for a in (feats, lens, tgts, tlens)))
             for i in range(accum)]
    want_g = jax.tree.map(lambda *g: sum(g) / accum, *parts)

    cfg, model = _port(params, d)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    topt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                  {"warmup_steps": 2})
    launches = (cat.chunk_train_attention.fwd_launches, cat.chunk_train_attention.bwd_launches)
    got_m = make_train_step(model, cfg, topt, sched, (C, L, R), accum_steps=accum)(
        *_t(feats, lens, tgts, tlens))
    assert launches == (cat.chunk_train_attention.fwd_launches,
                        cat.chunk_train_attention.bwd_launches)
    assert int(got_m["step"]) == int(state.step) == 1
    for k in ("loss", "loss_ctc", "loss_att", "acc_att", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5, err_msg=k)

    # .grad holds the gradient clipped to norm 5; undo the clip to compare
    # with JAX's raw gradient
    unclip = max(1.0, float(got_m["grad_norm"]) / 5.0)
    for name, g, e in _grads_by_name(model, want_g, cfg):
        np.testing.assert_allclose(g.numpy() * unclip, e.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    lr = float(schedule(0))
    after = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for name, p in model.named_parameters():
        moved, want_moved = (p.detach() - before[name]).numpy(), (after[name] - before[name]).numpy()
        big = np.abs(p.grad.numpy() * unclip) > 1e-5
        np.testing.assert_allclose(moved[big], want_moved[big], atol=1e-6, err_msg=name)
        assert np.all(np.abs(moved - want_moved) <= 2 * lr + 1e-7), name
        assert np.abs(moved).max() > 0, name


def test_dots_policy_keeps_the_kernel_outputs(pair):
    """Under gradient checkpointing, "nothing" runs the training attention's
    forward twice per layer (forward and recompute) and "dots" once (its
    outputs are kept); both give the same gradients. Eval runs full context
    with no attention-kernel call and no gradient."""
    feats, lens, tgts, tlens = _batch(13)
    calls, grads = {}, {}
    params = pair[1]
    orig = cat.forward_plain
    for remat in ("nothing", "dots"):
        cfg, model = _port(params, _config(remat))
        n = [0]

        def counting(*a, **k):
            n[0] += 1
            return orig(*a, **k)

        cat.forward_plain = counting
        try:
            out, _ = model.encoder.forward_train(*_t(feats, lens), C, L, R, train=True)
            out.square().sum().backward()
        finally:
            cat.forward_plain = orig
        calls[remat] = n[0]
        grads[remat] = [p.grad for p in model.encoder.parameters()]
    assert calls == {"nothing": 4, "dots": 2}
    for a, b in zip(grads["nothing"], grads["dots"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    metrics = make_eval_step(model, cfg)(*_t(feats, lens, tgts, tlens))
    assert all(np.isfinite(float(v)) for v in metrics.values())
