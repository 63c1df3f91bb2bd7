"""The ``dp``, ``fsdp``, ``tp`` and ``fsdp_tp`` sharding modes of the port
(``parallel/mesh.py``, ``parallel/tensor_parallel.py``) on the CPU: 2 or 4
gloo processes started by the test with torchrun's environment, each
through ``Executor`` on its data index's share of every batch. The runs
of one world size share one launch (``launched``): each process trains
every case in turn.

A tiny CTC/AED model (2 layers, 64 d, 4 heads, layer-norm conv module,
(c, L, R) drawn from [8, -1] x [16] x [16]; the 1 + 1-block decoder, 4
heads), f32, two steps, adamw at lr 1e-4 and eps 1e-6 (the bars of
``tests/test_torch_executor.py``). Bars: per-step metrics (loss, its
parts, the attention accuracy, the global gradient norm) rtol 1e-5 and
parameters atol 1e-6 against the one-process port run on the whole
batches and, at dropout 0, against the JAX package's Executor with
``shard_params(mode)`` on a mesh of the same shape (the conftest's
virtual CPU devices). Where the data is split the statistics over the
global batch are taken over the data group (``parallel/data_group.py``):
a batch-norm conv module in ``dp`` and ``fsdp`` at accum_grad 1 and 2 and
in ``fsdp_tp`` on 2 x 2 (ROADMAP C16), the attention accuracy in every
case (C18), and the length-normalized attention loss on shares of unequal
token counts (C19). A process's share of a batch follows the Executor's
micro-batch contract: its share of each global micro-batch in turn.
``tp`` also at dropout 0.1 (positional, FFN, attention and decoder
dropout): the ranks draw the full-width masks and hash attention dropout
by global head, so the step equals the one-process step; there with a
batch-norm conv module. The batch-norm running statistics end equal on
every process (``worker`` checks). On the 2 x 2 mesh the JAX package's
gradient norm and convolution weights leave its own unsharded run (C17):
there the norm is held to the one-process run only and the convolutions
to JAX at 5e-5. A checkpoint saved under ``fsdp_tp`` resumes under ``dp``
and the reverse. ``bin/train.main`` under two processes with ``--sharding
fsdp`` and with ``--sharding tp --tp_size 2``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.parallel.mesh import make_mesh, shard_params
from chunkformer_tpu.train.executor import Executor as JaxExecutor
from chunkformer_tpu.train.optim import build_optimizer as jax_build_optimizer
from chunkformer_tpu.train.train_step import create_train_state
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params

from .test_torch_train_cli import _argv, micro  # noqa: F401 (the CLI's micro data)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = {"output_size": 64, "attention_heads": 4, "linear_units": 128, "num_blocks": 2,
       "cnn_module_kernel": 15, "cnn_module_norm": "layer_norm", "dynamic_conv": True,
       "dropout_rate": 0.0, "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0,
       "dynamic_chunk_sizes": [8, -1], "dynamic_left_context_sizes": [16],
       "dynamic_right_context_sizes": [16]}
DEC = {"attention_heads": 4, "linear_units": 128, "num_blocks": 1, "r_num_blocks": 1,
       "dropout_rate": 0.0, "positional_dropout_rate": 0.0}
OPTIM = {"lr": 1e-4, "eps": 1e-6}
# Adam's eps in the batch-norm cases: at 1e-6 a weight whose gradient is
# near eps turns summation-order rounding into differences of up to 8e-6,
# between the one-process port run and JAX as much as between processes
# (encoder.embed.out.weight at accum 2: gradient 6.7e-7)
BN_EPS = 1e-4


def _config(dropout=0.0, remat=False, norm="layer_norm", length_norm=False):
    enc = dict(ENC, dropout_rate=dropout, positional_dropout_rate=dropout,
               attention_dropout_rate=dropout, cnn_module_norm=norm)
    if remat:
        enc.update(gradient_checkpointing=True, remat_policy="dots")
    dec = dict(DEC, dropout_rate=dropout, positional_dropout_rate=dropout,
               self_attention_dropout_rate=dropout, src_attention_dropout_rate=dropout)
    return {"model": "asr_model", "encoder_conf": enc, "decoder": "bitransformer",
            "decoder_conf": dec,
            "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1,
                           "length_normalized_loss": length_norm},
            "output_dim": 40}


def _share(n, index, size, accum):
    """The rows of a global batch of ``n`` that data index ``index`` of
    ``size`` holds under the Executor's micro-batch contract: its share of
    each of the ``accum`` global micro-batches in turn."""
    m, k = n // accum, n // (accum * size)
    return np.concatenate([np.arange(j * m + index * k, j * m + (index + 1) * k)
                           for j in range(accum)])


def _batches(seed=0, n_batches=2, share=(0, 1), accum=1):
    """Global batches of 4 utterances; a data index takes its share."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        n, t, u = 4, 71, 6
        lens = rng.integers(50, t + 1, size=n).astype(np.int32)
        lens[0] = t
        ulen = rng.integers(2, u + 1, size=n).astype(np.int32)
        tgt = rng.integers(1, 39, size=(n, u)).astype(np.int64)
        tgt[np.arange(u)[None, :] >= ulen[:, None]] = -1
        b = {"feats": rng.normal(size=(n, t, 80)).astype(np.float32), "feats_lengths": lens,
             "target": tgt, "target_lengths": ulen}
        rows = _share(n, share[0], share[1], accum)
        out.append({key: v[rows] for key, v in b.items()})
    return out


def run(spec, dp=None):
    """Train ``spec['steps']`` steps from ``spec['init']`` (a state dict
    file) or a checkpoint (``spec['resume']``), then save ``spec['tag']``
    in ``spec['dir']``. Returns the Executor."""
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.parallel.mesh import Parallel
    from chunkformer_tpu_torch.train.checkpoint import load_checkpoint
    from chunkformer_tpu_torch.train.executor import Executor, pick_loss_fn
    from chunkformer_tpu_torch.train.optim import build_optimizer

    cfg = ChunkFormerConfig.from_dict(_config(spec["dropout"], spec["remat"], spec["norm"],
                                              spec["length_norm"]))
    model = ASRModel(cfg, cmvn=False)
    opt_state = sched_state = None
    if spec.get("resume"):
        state, opt_state, sched_state, _ = load_checkpoint(*spec["resume"])
    else:
        state = torch.load(spec["init"], weights_only=True)
    model.load_state_dict(state, strict=True)
    from chunkformer_tpu_torch.parallel.mesh import DataParallel

    dp = dp or DataParallel()
    parallel = Parallel(model, cfg, pick_loss_fn(cfg), dp)
    opt, sched = build_optimizer([p for p in model.parameters() if p.requires_grad], "adamw",
                                 dict(OPTIM, eps=spec["eps"]), "warmuplr",
                                 {"warmup_steps": 3})
    if opt_state is not None:
        parallel.load_optimizer_state(opt, opt_state)
        sched.load_state_dict(sched_state)
    ex = Executor(cfg, model, opt, sched, spec["dir"], log_interval=1,
                  accum_grad=spec["accum"], seed=3 + spec.get("seed_shift", 0), dp=dp,
                  parallel=parallel)
    ex.train_epoch(iter(_batches(spec["data_seed"], spec["steps"],
                                 (dp.data_rank, dp.data_size), spec["accum"])), epoch=0)
    ex.save(0, spec["tag"])
    return ex


def worker(specs_json):
    """One rank, with torchrun's environment set by the caller: trains each
    spec of the list in turn, in one process group."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    specs = json.loads(specs_json)
    for spec in specs if isinstance(specs, list) else [specs]:
        dp = init_distributed(torch.device("cpu"), spec["mode"], spec["tp"])
        ex = run(spec, dp)
        # batch-norm running statistics, from statistics over the data group,
        # agree across every process
        for name, buf in ex.model.named_buffers():
            if "running_" in name:
                got = [torch.empty_like(buf) for _ in range(dp.world)]
                dist.all_gather(got, buf)
                assert all(torch.equal(g, buf) for g in got), name
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, code, timeout=600):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)


def _sharded(spec, world):
    _spawn(world, f"from tests.test_torch_sharding import worker; worker({json.dumps(spec)!r})")


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close_metrics(got, want, skip=()):
    """Per-step metrics, the attention accuracy included."""
    assert len(got) == len(want) > 0
    skip = set(skip) | {"utts_per_s"}
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in ("scope", "step", "epoch"):
                assert g[k] == w[k], k
            elif k not in skip:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=k)


def _close_state(got, want, atol=1e-6, zero_grad=(), loose=(), behind=()):
    """Parameters within ``atol``; those in ``zero_grad``, whose gradient is
    0 up to rounding, within Adam's 2 * lr (two steps of at most lr each);
    those in ``behind`` (a batch norm's running mean behind such a bias,
    whose statistics are summed over the data group) within the norm's
    momentum (0.1) times that; those in ``loose`` within 5e-5 (ROADMAP
    C17)."""
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        tol = (2 * OPTIM["lr"] if k in zero_grad else 0.1 * 2 * OPTIM["lr"] if k in behind
               else 5e-5 if k in loose else atol)
        torch.testing.assert_close(got[k].float(), want[k].float(), atol=tol, rtol=0, msg=k)


def _ckpt(path, tag):
    from chunkformer_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(str(path), tag)


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The JAX initial parameters and their port state dicts on disk, with
    a layer-norm and a batch-norm conv module: (layer-norm params, its
    path, the batch-norm path, the batch-norm params)."""
    root = tmp_path_factory.mktemp("init")
    out = []
    for norm in ("layer_norm", "batch_norm"):
        params = init_asr_model(jax.random.PRNGKey(7), JaxConfig.from_dict(_config(norm=norm)))
        params = jax.tree.map(np.asarray, params)
        path = str(root / f"{norm}.pt")
        cfg = ChunkFormerConfig.from_dict(_config(norm=norm))
        torch.save(state_dict_from_jax_params(params, cfg), path)
        out += [params, path] if norm == "layer_norm" else [path, params]
    return tuple(out)


def _spec(tmp_path, init, name, mode, tp, accum=1, dropout=0.0, remat=False,
          norm="layer_norm", length_norm=False, eps=OPTIM["eps"], **kw):
    path = init[1] if norm == "layer_norm" else init[2]
    return {"mode": mode, "tp": tp, "accum": accum, "dropout": dropout, "remat": remat,
            "norm": norm, "length_norm": length_norm, "eps": eps, "init": path,
            "dir": str(tmp_path / name), "tag": "ckpt", "steps": 2, "data_seed": 0, **kw}


def _case_eps(norm):
    return BN_EPS if norm == "batch_norm" else OPTIM["eps"]


def _jax_run(tmp_path, init, mode, data, model, accum, norm="layer_norm", length_norm=False):
    """The JAX package's Executor with ``shard_params(mode)`` on a (data,
    model) mesh of the conftest's CPU devices."""
    conf = _config(norm=norm, length_norm=length_norm)
    jcfg = JaxConfig.from_dict({**conf, "encoder_conf": {**conf["encoder_conf"],
                                                         "use_pallas_train": False}})
    mesh = make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    params = init[0] if norm == "layer_norm" else init[3]
    params = shard_params(jax.tree.map(np.copy, params), mesh, mode)
    jopt, _ = jax_build_optimizer("adamw", dict(OPTIM, eps=_case_eps(norm)), "warmuplr",
                                  {"warmup_steps": 3})
    ex = JaxExecutor(jcfg, jopt, str(tmp_path / "jax"), log_interval=1, accum_grad=accum,
                     seed=3, mesh=mesh)
    with mesh:
        state = ex.train_epoch(create_train_state(params, jopt), iter(_batches()), epoch=0)
    return (state_dict_from_jax_params(jax.tree.map(np.asarray, state.params),
                                       ChunkFormerConfig.from_dict(conf)),
            _metrics(tmp_path / "jax" / "metrics.jsonl"))


# (mode, processes, tp_size, accum_grad, remat, conv-module norm, length-normalized loss)
CASES = [
    pytest.param("fsdp", 2, 1, 2, True, "layer_norm", False, id="fsdp-2-1-2-True"),
    pytest.param("tp", 2, 2, 1, False, "layer_norm", False, id="tp-2-2-1-False"),
    pytest.param("fsdp_tp", 4, 2, 1, True, "layer_norm", False, id="fsdp_tp-4-2-1-True"),
    # batch statistics over the data group (C16)
    pytest.param("dp", 2, 1, 1, False, "batch_norm", False, id="dp-2-1-1-bn"),
    pytest.param("dp", 2, 1, 2, False, "batch_norm", False, id="dp-2-1-2-bn"),
    pytest.param("fsdp", 2, 1, 1, True, "batch_norm", False, id="fsdp-2-1-1-bn"),
    pytest.param("fsdp", 2, 1, 2, True, "batch_norm", False, id="fsdp-2-1-2-bn"),
    pytest.param("fsdp_tp", 4, 2, 1, True, "batch_norm", False, id="fsdp_tp-4-2-1-bn"),
    # the length-normalized attention loss over the group's tokens (C19)
    pytest.param("dp", 2, 1, 2, False, "layer_norm", True, id="dp-2-1-2-lnorm"),
    pytest.param("fsdp", 2, 1, 1, True, "layer_norm", True, id="fsdp-2-1-1-lnorm"),
]


def _case_name(mode, world, tp, accum, remat, norm, length_norm):
    return f"{mode}-{world}-{tp}-{accum}-{remat}-{norm}-{length_norm}"


@pytest.fixture(scope="module")
def launched(tmp_path_factory, init):
    """Every sharded run of this file that starts from the initial
    parameters, one launch a world size: {name: its directory}. Besides the
    cases, "tp-dropout" (``tp`` at dropout 0.1 with a batch-norm conv
    module)."""
    root = tmp_path_factory.mktemp("sharded")
    specs = {}
    for case in CASES:
        mode, world, tp, accum, remat, norm, length_norm = case.values
        name = _case_name(*case.values)
        specs.setdefault(world, []).append(_spec(root, init, name, mode, tp, accum,
                                                 remat=remat, norm=norm,
                                                 length_norm=length_norm,
                                                 eps=_case_eps(norm)))
    specs[2].append(_spec(root, init, "tp-dropout", "tp", 2, dropout=0.1, norm="batch_norm"))
    for world, group in specs.items():
        _sharded(group, world)
    return {os.path.basename(s["dir"]): s["dir"] for group in specs.values() for s in group}


def _tokens(accum, share):
    """Each micro-batch's attention targets (eos included) in a share."""
    return [[int(part.sum()) + len(part) for part in np.split(b["target_lengths"], accum)]
            for b in _batches(0, 2, share, accum)]


@pytest.mark.parametrize("mode,world,tp,accum,remat,norm,length_norm", CASES)
def test_sharded_step_equals_one_process_and_jax(tmp_path, init, launched, mode, world, tp,
                                                 accum, remat, norm, length_norm):
    sharded = launched[_case_name(mode, world, tp, accum, remat, norm, length_norm)]
    one = run(_spec(tmp_path, init, "one", "dp", 1, accum, remat=remat, norm=norm,
                    length_norm=length_norm, eps=_case_eps(norm)))
    assert one.step == 2
    got = _ckpt(sharded, "ckpt")
    want = _ckpt(tmp_path / "one", "ckpt")
    split = world > tp
    if length_norm:  # the data group's shares hold different token counts
        data = world // tp
        counts = [_tokens(accum, (i, data)) for i in range(data)]
        assert counts[0] != counts[1]
    # the batch norm removes the depthwise conv's bias: its gradient is 0 up
    # to rounding
    zero = {k for k in want[0] if norm == "batch_norm" and k.endswith("depthwise_conv.bias")}
    behind = {k.replace("depthwise_conv.bias", "norm.running_mean") for k in zero}
    _close_metrics(_metrics(os.path.join(sharded, "metrics.jsonl")),
                   _metrics(tmp_path / "one" / "metrics.jsonl"))
    _close_state(got[0], want[0], zero_grad=zero, behind=behind)
    jax_state, jax_metrics = _jax_run(tmp_path, init, mode, world // tp, tp, accum, norm,
                                      length_norm)
    # the JAX package's grad_norm on a mesh with both axes above 1 is not
    # its unsharded value (ROADMAP C17); the port's equals the unsharded one
    _close_metrics(_metrics(os.path.join(sharded, "metrics.jsonl")), jax_metrics,
                   skip={"grad_norm"} if split and tp > 1 else ())
    # on a mesh with both axes above 1 the JAX package's convolution weights
    # move up to 1.3e-5 off its own unsharded run (C17)
    conv = {k for k in jax_state if split and tp > 1 and (
        k.startswith("encoder.embed.conv") or "depthwise_conv" in k)}
    # the JAX Executor leaves the batch-norm running statistics at their
    # initial values; the port updates them as the reference does (C1,
    # PR 6), so they are held to the one-process run above only
    jax_state = {k: v for k, v in jax_state.items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    _close_state({k: v for k, v in got[0].items() if k in jax_state}, jax_state, loose=conv,
                 zero_grad=zero)
    # one checkpoint format: Adam's moments at the full shapes, the same count
    assert got[1]["state"].keys() == want[1]["state"].keys()
    for i, st in want[1]["state"].items():
        assert int(got[1]["state"][i]["step"]) == int(st["step"]) == 2
        for k in ("exp_avg", "exp_avg_sq"):
            assert got[1]["state"][i][k].shape == st[k].shape
    # the weights moved well past the bar
    k = "encoder.encoders.0.feed_forward.w_1.weight"
    assert float((want[0][k] - torch.load(init[1])[k]).abs().max()) > 1e-5


def test_tp_step_with_dropout_equals_one_process(tmp_path, init, launched):
    """With a batch-norm conv module: the processes of the model group see
    the same batch and keep equal running statistics (``worker`` checks)."""
    tp = launched["tp-dropout"]
    run(_spec(tmp_path, init, "one", "dp", 1, dropout=0.1, norm="batch_norm"))
    _close_metrics(_metrics(os.path.join(tp, "metrics.jsonl")),
                   _metrics(tmp_path / "one" / "metrics.jsonl"))
    # the depthwise conv's bias feeds the batch norm, which removes it: its
    # gradient is 0 up to rounding
    got, want = _ckpt(tp, "ckpt")[0], _ckpt(tmp_path / "one", "ckpt")[0]
    _close_state(got, want, zero_grad={k for k in want if k.endswith("depthwise_conv.bias")})
    # the dropout is on: the same run without it ends elsewhere
    run(_spec(tmp_path, init, "nodrop", "dp", 1, norm="batch_norm"))
    a, b = _ckpt(tmp_path / "one", "ckpt")[0], _ckpt(tmp_path / "nodrop", "ckpt")[0]
    k = "encoder.encoders.0.feed_forward.w_1.weight"
    assert float((a[k] - b[k]).abs().max()) > 1e-6


def test_checkpoints_cross_between_fsdp_tp_and_dp(tmp_path, init, launched):
    """Two steps under fsdp_tp and under dp give one checkpoint; each
    resumes under the other mode for a third step, to the same weights."""
    # the fsdp_tp case's run: two steps under fsdp_tp (2 x 2, remat)
    shutil.copytree(launched[_case_name(*CASES[2].values)], tmp_path / "a")
    run(_spec(tmp_path, init, "b", "dp", 1, remat=True))
    a, b = _ckpt(tmp_path / "a", "ckpt"), _ckpt(tmp_path / "b", "ckpt")
    _close_state(a[0], b[0])
    for i in b[1]["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(a[1]["state"][i][k], b[1]["state"][i][k], atol=1e-7,
                                       rtol=1e-4)
    third = dict(steps=1, data_seed=5, tag="ckpt3")
    run(_spec(tmp_path, init, "a", "dp", 1, remat=True, resume=(str(tmp_path / "a"), "ckpt"),
              **third))
    _sharded(_spec(tmp_path, init, "b", "fsdp_tp", 2, remat=True,
                   resume=(str(tmp_path / "b"), "ckpt"), **third), 4)
    a3, b3 = _ckpt(tmp_path / "a", "ckpt3"), _ckpt(tmp_path / "b", "ckpt3")
    assert int(a3[3]["step"]) == int(b3[3]["step"]) == 3
    _close_state(a3[0], b3[0])


# ------------------------------------------------------------------ the CLI


def cli_worker(argv_json):
    torch.set_num_threads(1)
    from chunkformer_tpu_torch.bin import train

    assert train.main(json.loads(argv_json)) == 0


@pytest.mark.parametrize("extra", [["--sharding", "fsdp"], ["--sharding", "tp", "--tp_size", "2"]])
def test_train_cli_shards_over_two_processes(micro, tmp_path, extra):
    """Two processes of ``bin/train.py --distributed``: with tp over both
    (one data index, so every process reads the whole list) the run equals
    the one-process CLI run; with fsdp each reads its half. Either way the
    checkpoints load into the single-process model."""
    from chunkformer_tpu_torch.bin import train

    # lr 1e-4 and eps 1e-6, as the Executor bars: Adam on the near-zero key
    # bias gradients turns summation order into differences of up to lr
    opt = ["--override_config", "optim_conf.lr 0.0001", "--override_config",
           "optim_conf.eps 0.000001"]
    argv = _argv(micro, tmp_path / "exp", "--distributed", *extra, *opt)
    _spawn(2, f"from tests.test_torch_sharding import cli_worker; "
              f"cli_worker({json.dumps(argv)!r})")
    assert train.main(_argv(micro, tmp_path / "one", *opt)) == 0
    for epoch in (0, 1):
        got = _ckpt(tmp_path / "exp", f"epoch_{epoch}")
        want = _ckpt(tmp_path / "one", f"epoch_{epoch}")
        tp = "tp" in extra
        assert got[3]["step"] == (want[3]["step"] if tp else epoch + 1)
        if tp:
            _close_state(got[0], want[0])
        else:
            assert {k: v.shape for k, v in got[0].items()} == {
                k: v.shape for k, v in want[0].items()}


# ------------------------------------------------- the kernels' plain versions


def test_plain_training_attention_on_local_heads_equals_the_slice():
    """The plain forward and backward of B4/B5 on heads 2-3 of 4 with
    head_offset 2 and heads_total 4, at dropout 0.1: the full call's slice
    (ctx, m, den and the five gradients; the masks bit for bit)."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    g = torch.Generator().manual_seed(0)
    b, n, c, left, right, h, dk = 3, 3, 8, 16, 8, 4, 16
    rnd = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    args = [rnd(b, n * c, h, dk), rnd(b, left + n * c + right, h, 2 * dk),
            rnd(2 * c - 1 + left + right, h, dk), rnd(h, dk), rnd(h, dk),
            torch.tensor([n * c - 2, n * c - 9, c + 1], dtype=torch.int32)]
    st = (91, c, left, right, 0.1)
    loc = [t[..., 2:4, :].contiguous() for t in args[:3]] + [
        args[3][2:4].contiguous(), args[4][2:4].contiguous(), args[5]]
    ctx, m, den = cat.forward_plain(*args, *st)
    lctx, lm, lden = cat.forward_plain(*loc, *st, head_offset=2, heads_total=4)
    torch.testing.assert_close(lctx, ctx[:, :, 2:4], atol=1e-6, rtol=0)
    torch.testing.assert_close(lm, m[:, 2:4], atol=1e-6, rtol=0)
    torch.testing.assert_close(lden, den[:, 2:4], atol=1e-6, rtol=1e-6)
    dctx = rnd(*ctx.shape)
    full = cat.backward_plain(*args, m, den, dctx, *st)
    part = cat.backward_plain(*loc, lm, lden, dctx[:, :, 2:4].contiguous(), *st, head_offset=2,
                              heads_total=4)
    for name, a, e in zip(("dq", "dkv", "dp", "du", "dv"), part, full):
        torch.testing.assert_close(a, e[..., 2:4, :], atol=1e-5, rtol=1e-6, msg=name)
    w = left + c + right
    keep = cat.window_keep_mask(91, args[5], n, h, c, w, 0.1)
    assert torch.equal(cat.window_keep_mask(91, args[5], n, 2, c, w, 0.1, 2, 4),
                       keep[:, :, 2:4])
    assert not torch.equal(cat.window_keep_mask(91, args[5], n, 2, c, w, 0.1), keep[:, :, 2:4])
    # the tensor-core backward sizes its dP groups by the global head count
    assert cat.partial_shapes("tensor_core", 32, 4, 4, 64, 383, 64, heads_total=8)[0][0] == (
        cat.partial_shapes("tensor_core", 32, 4, 8, 64, 383, 64)[0][0][0], 4, 383, 64)
