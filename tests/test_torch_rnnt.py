"""The port's RNN-T losses and transducer train step against the JAX package
on the CPU.

The lattice recursions (``ops/rnnt.py``) on random log-probs and joint
outputs from a seed; ``transducer_model_loss`` in its three branches (the k2
smoothed + pruned loss early and late in its warmup, the pruned loss on the
diagonal band, the full lattice with and without the HAT joint) on the
tiny transducer of ``tests/test_torch_transducer.py`` (encoder 2 x 64 d,
vocab 64, dropout 0); and one ``make_train_step(loss_fn=
transducer_model_loss)`` step at (c, L, R) = (8, 16, 16) against JAX's with
its Pallas training attention in interpret mode.

Tolerances: losses rtol 1e-5 (and the O(T * U) reference loop); gradients
atol 1e-4 rtol 1e-4; prune bounds identical; the train step's bars of
``tests/test_torch_train.py``: metrics rtol 1e-5, gradients 1e-4,
parameters after the adamw update atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.transducer import init_transducer
from chunkformer_tpu.ops import rnnt as jr
from chunkformer_tpu.train.losses import transducer_model_loss as jax_loss
from chunkformer_tpu.train.optim import build_optimizer as jax_build_optimizer
from chunkformer_tpu.train.train_step import (create_train_state, make_eval_step as jax_eval,
                                              make_train_step as jax_step)
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params
from chunkformer_tpu_torch.models.transducer import TransducerModel
from chunkformer_tpu_torch.ops import rnnt as tr
from chunkformer_tpu_torch.train.losses import transducer_model_loss
from chunkformer_tpu_torch.train.optim import build_optimizer
from chunkformer_tpu_torch.train.train_step import make_eval_step, make_train_step

from .test_torch_transducer import RNNT, V

TOL = dict(atol=1e-4, rtol=1e-4)
C, L, R = 8, 16, 16


def _lattice(seed, b=3, t=12, u=5, v=10):
    rng = np.random.default_rng(seed)
    targets = rng.integers(1, v, size=(b, u)).astype(np.int32)
    in_lens = np.asarray([t, t - 3, 5][:b], np.int32)
    tgt_lens = np.asarray([u, u - 2, 1][:b], np.int32)
    return rng, targets, in_lens, tgt_lens


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_rnnt_loss_matches_reference_and_jax():
    """rnnt_loss on a ragged batch: against the port's O(T * U) loop and
    JAX's rnnt_loss at rtol 1e-5; gradients of a weighted sum through the
    log-softmax against jax.grad."""
    rng, targets, in_lens, tgt_lens = _lattice(0)
    logits = rng.normal(size=(3, 12, 6, 10)).astype(np.float32)
    w = np.asarray([1.0, 2.0, 3.0], np.float32)

    def jloss(lg):
        return jr.rnnt_loss(jax.nn.log_softmax(lg, -1), *map(jnp.asarray, (targets, in_lens,
                                                                          tgt_lens)))

    want = jloss(jnp.asarray(logits))
    want_g = jax.grad(lambda lg: (jloss(lg) * w).sum())(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    lp = torch.log_softmax(lt, -1)
    got = tr.rnnt_loss(lp, *_t(targets, in_lens, tgt_lens))
    (got * torch.from_numpy(w)).sum().backward()
    ref = tr.rnnt_loss_reference(lp.detach(), *_t(targets, in_lens, tgt_lens))
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), **TOL)
    assert np.isfinite(lt.grad.numpy()).all()


@pytest.mark.parametrize("lm_only,am_only,delay", [(0.25, 0.0, 0.0), (0.0, 0.0, 0.0),
                                                    (0.2, 0.1, 0.05)])
def test_smoothed_loss_matches_jax(lm_only, am_only, delay):
    """rnnt_loss_smoothed (the arcs and the lattice) and its gradients with
    respect to am and lm."""
    rng, targets, in_lens, tgt_lens = _lattice(1)
    am = rng.normal(size=(3, 12, 10)).astype(np.float32)
    lm = rng.normal(size=(3, 6, 10)).astype(np.float32)
    args = (targets, in_lens, tgt_lens)

    def jloss(a, m):
        return jr.rnnt_loss_smoothed(a, m, *map(jnp.asarray, args), 0, lm_only, am_only, delay)

    want = jloss(jnp.asarray(am), jnp.asarray(lm))
    want_g = jax.grad(lambda a, m: jloss(a, m).sum(), argnums=(0, 1))(jnp.asarray(am),
                                                                       jnp.asarray(lm))
    at, mt = (torch.from_numpy(x).requires_grad_() for x in (am, lm))
    got = tr.rnnt_loss_smoothed(at, mt, *_t(*args), 0, lm_only, am_only, delay)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want_g[0]), **TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(want_g[1]), **TOL)


@pytest.mark.parametrize("s_range", [2, 3, 8])
def test_prune_bounds_match_jax(s_range):
    """rnnt_prune_bounds from the smoothed arcs: identical band starts
    (s_range 8 is wider than the lattice)."""
    rng, targets, in_lens, tgt_lens = _lattice(2, t=16, u=6)
    am = rng.normal(size=(3, 16, 10)).astype(np.float32)
    lm = rng.normal(size=(3, 7, 10)).astype(np.float32)
    args = (targets, in_lens, tgt_lens)
    jl, jb = jr.rnnt_smoothed_arcs(jnp.asarray(am), jnp.asarray(lm), *map(jnp.asarray, args))
    want = jr.rnnt_prune_bounds(jl, jb, jnp.asarray(in_lens), jnp.asarray(tgt_lens), s_range)
    tl, tb = tr.rnnt_smoothed_arcs(*_t(am, lm, *args))
    got = tr.rnnt_prune_bounds(tl, tb, *_t(in_lens, tgt_lens), s_range)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if s_range < 7:
        assert len(np.unique(got.numpy())) > 2
    else:
        assert not got.any()


@pytest.mark.parametrize("bounds", ["diagonal", "pruned", "wide"])
def test_pruned_loss_matches_jax(bounds):
    """rnnt_loss_pruned (tanh joint with a [J, V] output) on the diagonal
    band, on rnnt_prune_bounds' bands with a delay penalty, and on a band as
    wide as the lattice (where it equals the full loss); values and the
    gradients with respect to the encoder and predictor projections and the
    output weight."""
    rng, targets, in_lens, tgt_lens = _lattice(3, t=12, u=5)
    j = 8
    enc = rng.normal(size=(3, 12, j)).astype(np.float32)
    pred = rng.normal(size=(3, 6, j)).astype(np.float32)
    w_out = (rng.normal(size=(j, 10)) * 0.5).astype(np.float32)
    s_range = 6 if bounds == "wide" else 3
    delay = 0.02 if bounds == "pruned" else 0.0
    args = (targets, in_lens, tgt_lens)
    jb = tb = None
    if bounds == "pruned":
        am = rng.normal(size=(3, 12, 10)).astype(np.float32)
        lm = rng.normal(size=(3, 6, 10)).astype(np.float32)
        jb = jr.rnnt_prune_bounds(*jr.rnnt_smoothed_arcs(
            jnp.asarray(am), jnp.asarray(lm), *map(jnp.asarray, args)),
            jnp.asarray(in_lens), jnp.asarray(tgt_lens), s_range)
        tb = torch.from_numpy(np.array(jb))

    def jloss(e, p, wo):
        return jr.rnnt_loss_pruned(e, p, wo, *map(jnp.asarray, args),
                                   lambda w, x: jnp.tanh(x) @ w, s_range=s_range, bounds=jb,
                                   delay_penalty=delay)

    jin = tuple(map(jnp.asarray, (enc, pred, w_out)))
    want = jloss(*jin)
    want_g = jax.grad(lambda *a: jloss(*a).sum(), argnums=(0, 1, 2))(*jin)
    tin = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, w_out)]
    got = tr.rnnt_loss_pruned(tin[0], tin[1], *_t(*args), lambda x: torch.tanh(x) @ tin[2],
                              s_range=s_range, bounds=tb, delay_penalty=delay)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    for g, w in zip(tin, want_g):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **TOL)
    if bounds == "wide":
        lp = torch.log_softmax(torch.tanh(tin[0][:, :, None] + tin[1][:, None]) @ tin[2], -1)
        full = tr.rnnt_loss(lp, *_t(*args))
        np.testing.assert_allclose(got.detach().numpy(), full.detach().numpy(), rtol=1e-5)


def _jax_cfg(d):
    cfg = JaxConfig.from_dict(d)
    cfg.vocab_size = V
    cfg.encoder_conf.use_pallas_train = True
    cfg.encoder_conf.pallas_interpret = True
    return cfg


BRANCHES = {  # name: (predictor, hat, model_conf, step)
    "k2_start": ("rnn", False, {"ctc_weight": 0.1, "attention_weight": 0.15,
                                "transducer_weight": 0.75, "enable_k2": True,
                                "prune_range": 3, "warmup_steps": 4}, 0),
    "k2_late": ("rnn", False, {"ctc_weight": 0.1, "attention_weight": 0.15, "enable_k2": True,
                               "prune_range": 3, "warmup_steps": 2, "delay_penalty": 0.01,
                               "lm_only_scale": 0.2, "am_only_scale": 0.1}, 5),
    "pruned": ("embedding", False, {"ctc_weight": 0.2, "use_pruned_loss": True,
                                    "prune_range": 3}, 0),
    "full": ("conv", False, {"ctc_weight": 0.0, "attention_weight": 0.2}, 0),
    "full_hat": ("rnn", True, {"ctc_weight": 0.3, "attention_weight": 0.0}, 0),
}


def _pair(name):
    ptype, hat, mc, step = BRANCHES[name]
    d = {**RNNT, "predictor": ptype, "joint_conf": {**RNNT["joint_conf"], "hat_joint": hat},
         "model_conf": {**mc, "lsm_weight": 0.1}}
    jcfg = _jax_cfg(d)
    params = jax.tree.map(np.asarray, init_transducer(jax.random.PRNGKey(3), jcfg))
    cfg = ChunkFormerConfig.from_dict(d)
    cfg.vocab_size = V
    model = TransducerModel(cfg, cmvn=False)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return d, jcfg, params, cfg, model, step


def _batch(seed, b=3, t=110, lens=(110, 77, 64), u=7, tlens=(7, 4, 2)):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 80)).astype(np.float32)
    tgts = rng.integers(1, V - 2, size=(b, u)).astype(np.int32)
    tlens = np.asarray(tlens, np.int32)
    tgts[np.arange(u)[None, :] >= tlens[:, None]] = -1
    return feats, np.asarray(lens, np.int32), tgts, tlens


def _grads_by_name(model, jax_grads, cfg):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads), cfg)
    return [(name, p.grad, want[name]) for name, p in model.named_parameters()]


@pytest.mark.parametrize("name", list(BRANCHES))
def test_transducer_model_loss_matches_jax(name):
    """transducer_model_loss at full context in train mode (dropout 0): each
    metric at rtol 1e-5 and every parameter's gradient at 1e-4, by name."""
    d, jcfg, params, cfg, model, step = _pair(name)
    batch = _batch(4)

    def jfn(p):
        m = jax_loss(p, jcfg, *map(jnp.asarray, batch), train=True, step=step)
        return m["loss"], m

    (_, want), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    got = transducer_model_loss(model, cfg, *_t(*batch), train=True, step=step)
    got["loss"].backward()
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    for pname, g, e in _grads_by_name(model, want_g, cfg):
        assert g is not None or not np.any(e.numpy()), pname
        np.testing.assert_allclose(g.numpy() if g is not None else 0 * e.numpy(), e.numpy(),
                                   **TOL, err_msg=pname)


def test_transducer_train_step_matches_jax():
    """One make_train_step(loss_fn=transducer_model_loss) step on the k2
    branch at (8, 16, 16) (adamw, clip 5, warmup 2) against JAX's
    make_train_step(loss_fn=transducer_model_loss) with the Pallas training
    attention in interpret mode: metrics, gradients by name and the
    parameters after the update. Before the step, make_eval_step with the
    same loss against JAX's (full context, train=False): metrics rtol 1e-5."""
    d, jcfg, params, _, _, _ = _pair("k2_start")
    batch = _batch(5)

    opt, schedule = jax_build_optimizer("adamw", {"lr": 1e-3}, "warmuplr", {"warmup_steps": 2})
    step = jax.jit(jax_step(jcfg, opt, chunk_cfg=(C, L, R), loss_fn=jax_loss))
    state, want_m = step(create_train_state(params, opt), *map(jnp.asarray, batch),
                         jax.random.PRNGKey(0))
    want_g = jax.jit(jax.grad(lambda p: jax_loss(p, jcfg, *map(jnp.asarray, batch), C, L, R,
                                                 train=True)["loss"]))(
        jax.tree.map(jnp.asarray, params))

    cfg = ChunkFormerConfig.from_dict(d)
    cfg.vocab_size = V
    model = TransducerModel(cfg, cmvn=False)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    want_e = jax.jit(jax_eval(jcfg, loss_fn=jax_loss))(jax.tree.map(jnp.asarray, params),
                                                      *map(jnp.asarray, batch))
    got_e = make_eval_step(model, cfg, loss_fn=transducer_model_loss)(*_t(*batch))
    assert set(got_e) == set(want_e), (sorted(got_e), sorted(want_e))
    for k in want_e:
        np.testing.assert_allclose(float(got_e[k]), float(want_e[k]), rtol=1e-5, err_msg=k)
    topt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                  {"warmup_steps": 2})
    got_m = make_train_step(model, cfg, topt, sched, (C, L, R),
                            loss_fn=transducer_model_loss)(*_t(*batch))
    assert int(got_m["step"]) == int(state.step) == 1
    for k in ("loss", "loss_rnnt", "loss_ctc", "loss_att", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5, err_msg=k)
    unclip = max(1.0, float(got_m["grad_norm"]) / 5.0)
    for name, g, e in _grads_by_name(model, want_g, cfg):
        np.testing.assert_allclose(g.numpy() * unclip, e.numpy(), **TOL, err_msg=name)
    lr = float(schedule(0))
    after = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for name, p in model.named_parameters():
        moved = (p.detach() - before[name]).numpy()
        want_moved = (after[name] - before[name]).numpy()
        big = np.abs(p.grad.numpy() * unclip) > 1e-5
        np.testing.assert_allclose(moved[big], want_moved[big], atol=1e-6, err_msg=name)
        assert np.all(np.abs(moved - want_moved) <= 2 * lr + 1e-7), name
