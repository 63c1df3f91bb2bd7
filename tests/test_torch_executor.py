"""The port's training infrastructure against the JAX package on the CPU:
the six schedulers and ``freeze_modules`` (through the optimizer the port
builds), ``Executor.train_epoch`` and ``cv`` for a CTC/AED and a
classification model, ``pick_loss_fn``, checkpoints, averaging and
``load_trained_modules``.

Tiny models (2 layers, 64 d, 4 heads; dynamic chunk lists [8, -1] with
L = R = 16, so the (c, L, R) draws of ``random.Random(seed)`` matter), f32,
dropout 0; weights carried from JAX with ``state_dict_from_jax_params``; the
JAX encoder runs its plain XLA training attention. Bars: learning rates
rtol 1e-6 (optax evaluates the schedule in float32); per-step metrics and
the cv loss rtol 1e-5; parameters after training atol 1e-6; frozen
parameters bitwise unchanged; averaged checkpoints atol 1e-7.
"""

import json

import jax
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.models.classification import init_classification_model
from chunkformer_tpu.train import checkpoint as jckpt
from chunkformer_tpu.train.executor import Executor as JaxExecutor
from chunkformer_tpu.train.optim import build_optimizer as jax_build_optimizer
from chunkformer_tpu.train.optim import build_schedule as jax_build_schedule
from chunkformer_tpu.train.optim import freeze_modules as jax_freeze_modules
from chunkformer_tpu.train.train_step import create_train_state
from chunkformer_tpu.train.train_step import make_train_step as jax_make_train_step
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params
from chunkformer_tpu_torch.models.asr import ASRModel
from chunkformer_tpu_torch.models.classification import ClassificationModel
from chunkformer_tpu_torch.train import checkpoint as tckpt
from chunkformer_tpu_torch.train.executor import Executor, pick_loss_fn
from chunkformer_tpu_torch.train.losses import asr_model_loss, transducer_model_loss
from chunkformer_tpu_torch.train.optim import build_optimizer, freeze_modules
from chunkformer_tpu_torch.train.train_step import make_train_step

torch.backends.cuda.matmul.allow_tf32 = False

ENC = {"output_size": 64, "attention_heads": 4, "linear_units": 128, "num_blocks": 2,
       "cnn_module_kernel": 15, "cnn_module_norm": "layer_norm", "dynamic_conv": True,
       "dropout_rate": 0.0, "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0,
       "dynamic_chunk_sizes": [8, -1], "dynamic_left_context_sizes": [16],
       "dynamic_right_context_sizes": [16]}
ASR = {"model": "asr_model", "encoder_conf": ENC, "decoder": "bitransformer",
       "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                        "r_num_blocks": 1, "dropout_rate": 0.0,
                        "positional_dropout_rate": 0.0},
       "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
       "output_dim": 40}
CLS = {"model": "classification", "encoder_conf": ENC,
       "model_conf": {"tasks": {"gender": 2, "emotion": 4}, "dropout_rate": 0.0,
                      "label_smoothing": 0.1},
       "output_dim": 40}
# Adam divides each update by the gradient's own scale, so on near-zero
# gradients (the key biases, whose gradient is 0 up to rounding) the two
# frameworks' summation-order noise becomes a difference of up to lr per
# step; eps 1e-6 damps it there and lr 1e-4 keeps three steps within 1e-6
# while the parameters move by about 3e-4.
OPTIM = {"lr": 1e-4, "eps": 1e-6}


def _jax_cfg(d):
    return JaxConfig.from_dict({**d, "encoder_conf": {**d["encoder_conf"],
                                                      "use_pallas_train": False}})


def _port(d, params, kind=ASRModel):
    cfg = ChunkFormerConfig.from_dict(d)
    model = kind(cfg, cmvn=False)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return cfg, model


def _asr_batches(ns, seed=0, t=71, u=6):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        lens = rng.integers(t - 25, t + 1, size=n).astype(np.int32)
        lens[0] = t
        ulen = rng.integers(2, u + 1, size=n).astype(np.int32)
        tgt = rng.integers(1, 39, size=(n, u)).astype(np.int64)
        tgt[np.arange(u)[None, :] >= ulen[:, None]] = -1
        out.append({"feats": rng.normal(size=(n, t, 80)).astype(np.float32),
                    "feats_lengths": lens, "target": tgt, "target_lengths": ulen})
    return out


def _cls_batches(ns, seed=1, t=71):
    rng = np.random.default_rng(seed)
    return [{"feats": rng.normal(size=(n, t, 80)).astype(np.float32),
             "feats_lengths": np.full(n, t, np.int32),
             "label_gender": rng.integers(0, 2, size=n).astype(np.int64),
             "label_emotion": rng.integers(0, 4, size=n).astype(np.int64)} for n in ns]


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close_params(port_model, jax_params, cfg, atol=1e-6):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_params), cfg)
    got = port_model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), atol=atol, rtol=0, msg=k)


# --------------------------------------------------------------- schedulers


@pytest.mark.parametrize("name,conf", [
    ("warmuplr", {"warmup_steps": 5}),
    ("warmup_policy", {"warmup_ratio": 0.3, "max_steps": 20, "min_lr": 2e-3}),
    ("squarerootconstantpolicy", {"constant_ratio": 0.25, "max_steps": 20, "min_lr": 1e-4}),
    ("cosineannealing", {"warmup_steps": 4, "max_steps": 20, "min_lr": 1e-5}),
    ("noamannealing", {"d_model": 64, "warmup_steps": 6, "min_lr": 1e-4}),
    ("NoamHoldAnnealing", {"warmup_ratio": 0.2, "hold_ratio": 0.3, "max_steps": 20,
                           "decay_rate": 0.5, "min_lr": 2e-4}),
])
def test_scheduler_lr_per_step_matches_optax(name, conf):
    """The learning rate each update of the port's optimizer uses equals the
    JAX schedule at optax's count (0 first), with floors and ratios."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = build_optimizer([p], "adamw", {"lr": 1e-3}, name, conf)
    want = jax_build_schedule(name, {**conf, "lr": 1e-3})
    for count in range(26):
        got = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(want(count)), rtol=1e-6, atol=0)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_freeze_modules_matches_optax_multi_transform():
    """Three adamw steps at clip 0.5 (active) with the embedding and the
    decoder frozen: frozen parameters bitwise unchanged; the rest equal to
    optax's multi_transform over the whole chain, whose clip norm covers
    the trainable leaves only."""
    patterns = ["encoder.embed", "decoder"]
    params = init_asr_model(jax.random.PRNGKey(4), _jax_cfg(ASR))
    cfg, model = _port(ASR, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _asr_batches([4], seed=5)[0]
    opt, sched = build_optimizer(freeze_modules(model, patterns), "adamw", OPTIM, "warmuplr",
                                 {"warmup_steps": 2})
    step = make_train_step(model, cfg, opt, sched, (8, 16, 16), grad_clip=0.5)
    jopt, _ = jax_build_optimizer("adamw", dict(OPTIM), "warmuplr", {"warmup_steps": 2},
                                  grad_clip=0.5)
    jopt = jax_freeze_modules(jopt, params, patterns)
    jstep = jax.jit(jax_make_train_step(_jax_cfg(ASR), jopt, (8, 16, 16)))
    state = create_train_state(params, jopt)
    arrays = [batch[k] for k in ("feats", "feats_lengths", "target", "target_lengths")]
    for _ in range(3):
        m = step(*map(torch.from_numpy, arrays))
        assert float(m["grad_norm"]) > 0.5
        state, _ = jstep(state, *arrays, jax.random.PRNGKey(0))
    frozen = [k for k in before if any(p in k for p in patterns)]
    assert frozen and len(frozen) < len(before)
    after = model.state_dict()
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    _close_params(model, state.params, cfg)


# ----------------------------------------------------------------- executor


def _train_both(tmp_path, d, batches, cv_batches, accum, tag, init, kind):
    params = init(jax.random.PRNGKey(7), _jax_cfg(d))
    cfg, model = _port(d, params, kind)  # before the JAX step donates the parameters
    jcfg = _jax_cfg(d)
    jopt, _ = jax_build_optimizer("adamw", dict(OPTIM), "warmuplr", {"warmup_steps": 3})
    jex = JaxExecutor(jcfg, jopt, str(tmp_path / f"jax_{tag}"), log_interval=1,
                      accum_grad=accum, seed=3)
    state = jex.train_epoch(create_train_state(params, jopt), iter(batches), epoch=0)
    jcv = jex.cv(state.params, iter(cv_batches))

    opt, sched = build_optimizer(list(model.parameters()), "adamw", OPTIM, "warmuplr",
                                 {"warmup_steps": 3})
    ex = Executor(cfg, model, opt, sched, str(tmp_path / f"port_{tag}"), log_interval=1,
                  accum_grad=accum, seed=3)
    ex.train_epoch(iter(batches), epoch=0)
    cv = ex.cv(iter(cv_batches))

    got = _metrics(tmp_path / f"port_{tag}" / "metrics.jsonl")
    want = _metrics(tmp_path / f"jax_{tag}" / "metrics.jsonl")
    assert len(got) == len(want) == len(batches) == ex.step
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in ("scope", "step", "epoch"):
                assert g[k] == w[k], k
            elif k != "utts_per_s":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=k)
    np.testing.assert_allclose(cv, jcv, rtol=1e-5, atol=0)
    _close_params(model, state.params, cfg)
    return ex


@pytest.mark.parametrize("accum", [1, 2])
def test_executor_train_epoch_and_cv_match_jax(tmp_path, accum):
    """A CTC/AED epoch of three batches (the last ragged: padded by
    repeating its final sample at accum_grad 2), then cv."""
    batches = _asr_batches([4, 4, 3], seed=2)
    ex = _train_both(tmp_path, ASR, batches, _asr_batches([3, 2], seed=9), accum, f"a{accum}",
                     init_asr_model, ASRModel)
    assert {c for c in ex._step_cache} <= {(8, 16, 16), (0, 0, 0)}
    assert len(ex.timings) == 3


def test_executor_classification_matches_jax(tmp_path):
    _train_both(tmp_path, CLS, _cls_batches([4, 4]), _cls_batches([3], seed=4), 1, "cls",
                init_classification_model, ClassificationModel)


RNNT = {"model": "transducer", "encoder_conf": ENC, "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32, "hidden_size": 32,
                           "num_layers": 1, "embed_dropout": 0.0},
        "joint_conf": {"join_dim": 48, "pred_output_size": 32},
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7},
        "output_dim": 40}


def test_executor_transducer_matches_jax(tmp_path):
    """A transducer epoch (full RNN-T loss plus CTC) through both
    Executors: ``pick_loss_fn`` gives each package its transducer loss."""
    from chunkformer_tpu.models.transducer import init_transducer
    from chunkformer_tpu_torch.models.transducer import TransducerModel

    def init(key, cfg):
        cfg.vocab_size = RNNT["output_dim"]
        return init_transducer(key, cfg)

    _train_both(tmp_path, RNNT, _asr_batches([3, 2], seed=6), _asr_batches([2], seed=8), 1,
                "rnnt", init, TransducerModel)


def test_pick_loss_fn():
    assert pick_loss_fn(ChunkFormerConfig.from_dict(ASR)) is asr_model_loss
    rnnt = {**ASR, "model": "transducer", "predictor": "rnn",
            "predictor_conf": {"embed_size": 32, "output_size": 32, "hidden_size": 32}}
    assert pick_loss_fn(ChunkFormerConfig.from_dict(rnnt)) is transducer_model_loss
    from chunkformer_tpu_torch.models.classification import classification_loss

    assert pick_loss_fn(ChunkFormerConfig.from_dict(CLS)) is classification_loss


def test_executor_save_writes_the_sidecar(tmp_path):
    params = init_asr_model(jax.random.PRNGKey(1), _jax_cfg(ASR))
    cfg, model = _port(ASR, params)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", OPTIM, "warmuplr", {})
    ex = Executor(cfg, model, opt, sched, str(tmp_path), log_interval=1, seed=3)
    ex.train_epoch(iter(_asr_batches([2])), epoch=0)
    ex.save(0, "epoch_0", cv_loss=1.5)
    state, opt_state, sched_state, info = tckpt.load_checkpoint(str(tmp_path), "epoch_0")
    assert {info["epoch"], info["step"], info["cv_loss"], info["tag"]} == {0, 1, 1.5, "epoch_0"}
    assert "save_time" in info and sched_state["last_epoch"] == 1
    assert opt_state["state"] and all(torch.equal(state[k], v)
                                      for k, v in model.state_dict().items())


# -------------------------------------------------------------- checkpoints


def _param_sets(n, seed=0):
    params = [init_asr_model(jax.random.PRNGKey(seed + i), _jax_cfg(ASR)) for i in range(n)]
    cfg = ChunkFormerConfig.from_dict(ASR)
    return cfg, params


@pytest.mark.parametrize("mode,num,min_step", [("best", 2, 0), ("last", 2, 0),
                                               ("best", 5, 20), ("last", 3, 15)])
def test_average_checkpoints_matches_jax(tmp_path, mode, num, min_step):
    """Four checkpoints saved by both packages from the same parameter sets
    (cv losses out of step order, one without cv_loss): the port's average
    equals the JAX average carried to the port's names (atol 1e-7)."""
    cfg, params = _param_sets(4)
    infos = [{"epoch": 0, "step": 10, "cv_loss": 3.0}, {"epoch": 1, "step": 20, "cv_loss": 1.0},
             {"epoch": 2, "step": 30}, {"epoch": 3, "step": 40, "cv_loss": 2.0}]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for i, (p, info) in enumerate(zip(params, infos)):
        jckpt.save_checkpoint(str(jdir), f"epoch_{i}", p, info_dict=info)
        tckpt.save_checkpoint(str(tdir), f"epoch_{i}", state_dict_from_jax_params(p, cfg),
                              info_dict=info)
    (tdir / "train.yaml").write_text("max_epoch: 4\n")
    assert [c["tag"] for c in tckpt.list_checkpoints(str(tdir))] == [
        c["tag"] for c in jckpt.list_checkpoints(str(jdir))]
    want = state_dict_from_jax_params(
        jckpt.average_checkpoints(str(jdir), num, mode, min_step), cfg)
    got = tckpt.average_checkpoints(str(tdir), num, mode, min_step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=1e-7, rtol=0, msg=k)


def test_checkpoint_round_trip_and_integer_buffers(tmp_path):
    """save/load/list; batch-norm running statistics are averaged and
    num_batches_tracked comes from the newest checkpoint."""
    d = {**ASR, "encoder_conf": {**ENC, "cnn_module_norm": "batch_norm"}}
    cfg = ChunkFormerConfig.from_dict(d)
    states = []
    for i in range(3):
        m = ASRModel(cfg, cmvn=False)
        sd = m.state_dict()
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                v.fill_(10 * (i + 1))
            elif k.endswith("running_mean"):
                v.fill_(float(i))
        states.append(sd)
        tckpt.save_checkpoint(str(tmp_path), f"s{i}", sd, {"x": torch.ones(2)},
                              {"last_epoch": i}, {"epoch": i, "step": 5 * i})
    with pytest.raises(FileNotFoundError):
        tckpt.average_checkpoints(str(tmp_path), min_step=100)
    model, opt, sched, info = tckpt.load_checkpoint(str(tmp_path), "s1")
    assert all(torch.equal(model[k], states[1][k]) for k in states[1])
    assert torch.equal(opt["x"], torch.ones(2)) and sched == {"last_epoch": 1}
    assert info == {"epoch": 1, "step": 5, "tag": "s1"}
    avg = tckpt.average_checkpoints(str(tmp_path), num=2, mode="last")
    nbt = [k for k in avg if k.endswith("num_batches_tracked")]
    rm = [k for k in avg if k.endswith("running_mean")]
    assert nbt and rm
    assert all(int(avg[k]) == 30 and avg[k].dtype == torch.int64 for k in nbt)
    assert all(torch.equal(avg[k], torch.full_like(avg[k], 1.5)) for k in rm)


def test_load_trained_modules_matches_jax(tmp_path):
    """--enc_init: the encoder.* tensors of the saved model replace the
    model's, everything else stays (JAX's load_trained_modules on the same
    parameters)."""
    cfg, (src, dst) = _param_sets(2, seed=11)
    jckpt.save_checkpoint(str(tmp_path / "jax"), "init", src)
    tckpt.save_checkpoint(str(tmp_path / "port"), "init", state_dict_from_jax_params(src, cfg))
    want = state_dict_from_jax_params(
        jckpt.load_trained_modules(dst, str(tmp_path / "jax"), "init", ["encoder."]), cfg)
    _, model = _port(ASR, dst)
    tckpt.load_trained_modules(model, str(tmp_path / "port"), "init", ["encoder."])
    got = model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    assert torch.equal(got["ctc.ctc_lo.weight"],
                       state_dict_from_jax_params(dst, cfg)["ctc.ctc_lo.weight"])
