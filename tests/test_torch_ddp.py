"""Data parallelism of the port (``parallel/mesh.py``) on the CPU: two
processes on gloo, each training on its half of every batch through
``Executor`` and DistributedDataParallel, against one process on the whole
batches. Two steps of a tiny CTC/AED model (2 layers, 64 d, 4 heads, (c, L,
R) drawn from [8, -1] x [16] x [16]), f32, dropout 0, at accum_grad 1 and 2
(the first micro-batch under DDP's ``no_sync``) and at ctc_weight 1 (the
decoder unused, so DDP searches for unused parameters): parameters within
1e-6. Imports no JAX: the oracle is the port's own single-process run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"model": "asr_model",
       "encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                        "num_blocks": 2, "cnn_module_kernel": 15,
                        "cnn_module_norm": "layer_norm", "dynamic_conv": True,
                        "dropout_rate": 0.0, "positional_dropout_rate": 0.0,
                        "attention_dropout_rate": 0.0, "dynamic_chunk_sizes": [8, -1],
                        "dynamic_left_context_sizes": [16],
                        "dynamic_right_context_sizes": [16]},
       "decoder": "bitransformer",
       "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                        "r_num_blocks": 1, "dropout_rate": 0.0,
                        "positional_dropout_rate": 0.0},
       "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
       "output_dim": 40}


def _batches(rank=None, world=1):
    """Two global batches of 4 utterances; a rank takes its contiguous share."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        n, t, u = 4, 71, 6
        b = {"feats": rng.normal(size=(n, t, 80)).astype(np.float32),
             "feats_lengths": rng.integers(50, t + 1, size=n).astype(np.int32),
             "target": rng.integers(1, 39, size=(n, u)).astype(np.int64),
             "target_lengths": rng.integers(2, u + 1, size=n).astype(np.int32)}
        if rank is not None:
            k = n // world
            b = {key: v[rank * k:(rank + 1) * k] for key, v in b.items()}
        out.append(b)
    return out


def _cfg(ctc_weight=0.3, reverse_weight=0.3):
    from chunkformer_tpu_torch.config import ChunkFormerConfig

    return ChunkFormerConfig.from_dict({**CFG, "model_conf": {
        **CFG["model_conf"], "ctc_weight": ctc_weight, "reverse_weight": reverse_weight}})


def _train(model_dir, dp=None, accum=1, ctc_weight=0.3):
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.train.executor import Executor
    from chunkformer_tpu_torch.train.optim import build_optimizer

    cfg = _cfg(ctc_weight)
    model = init_random_(ASRModel(cfg, cmvn=False), torch.Generator().manual_seed(5))
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-4, "eps": 1e-6},
                                 "warmuplr", {"warmup_steps": 2})
    ex = Executor(cfg, model, opt, sched, model_dir, log_interval=1, accum_grad=accum, seed=3,
                  dp=dp)
    ex.train_epoch(iter(_batches(dp.rank if dp else None, dp.world if dp else 1)), epoch=0)
    assert ex.step == 2
    return model


def worker(out_path, accum, ctc_weight):
    """One rank, with torchrun's environment set by the caller."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    dp = init_distributed(torch.device("cpu"))
    model = _train(os.path.dirname(out_path), dp, accum, ctc_weight)
    if dp.rank == 0:
        torch.save(model.state_dict(), out_path)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("accum,ctc_weight", [(1, 0.3), (2, 0.3), (2, 1.0)])
def test_two_process_gloo_equals_one_process(tmp_path, accum, ctc_weight):
    port = _free_port()
    out = str(tmp_path / "ddp.pt")
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"from tests.test_torch_ddp import worker; worker({out!r}, {accum}, {ctc_weight})"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    got = torch.load(out, weights_only=True)
    want = _train(str(tmp_path / "one"), accum=accum, ctc_weight=ctc_weight).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)
    # the two steps moved the weights well past the bar
    k = "encoder.encoders.0.feed_forward.w_1.weight"
    assert float((want[k] - _initial()[k]).abs().max()) > 1e-5


def _initial():
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_

    model = ASRModel(_cfg(), cmvn=False)
    return init_random_(model, torch.Generator().manual_seed(5)).state_dict()


def _tensors(b):
    return tuple(torch.from_numpy(b[k])
                 for k in ("feats", "feats_lengths", "target", "target_lengths"))


@pytest.mark.parametrize("ctc_weight,reverse_weight",
                         [(0.3, 0.3), (1.0, 0.3), (0.0, 0.3), (0.3, 0.0)])
def test_loss_leaves_unused_matches_the_autograd_graph(ctc_weight, reverse_weight):
    """``find_unused_parameters`` is on exactly where a backward of the
    CTC/AED loss leaves some parameter without a gradient."""
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.parallel.mesh import loss_leaves_unused
    from chunkformer_tpu_torch.train.losses import asr_model_loss

    cfg = _cfg(ctc_weight, reverse_weight)
    model = init_random_(ASRModel(cfg, cmvn=False), torch.Generator().manual_seed(5))
    asr_model_loss(model, cfg, *_tensors(_batches()[0]), 8, 16, 16)["loss"].backward()
    unused = [n for n, p in model.named_parameters() if p.grad is None]
    assert loss_leaves_unused(model, cfg) == bool(unused), unused


def test_train_step_runs_all_micro_batches_but_the_last_under_no_sync():
    import contextlib

    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.train.losses import asr_model_loss
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step

    cfg = _cfg()
    model = init_random_(ASRModel(cfg, cmvn=False), torch.Generator().manual_seed(5))
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-4},
                                 "warmuplr", {"warmup_steps": 2})
    synced, calls = [True], []

    @contextlib.contextmanager
    def no_sync():
        synced[0] = False
        yield
        synced[0] = True

    def loss_fn(*args, **kwargs):
        calls.append(synced[0])
        return asr_model_loss(*args, **kwargs)

    make_train_step(model, cfg, opt, sched, (8, 16, 16), accum_steps=4, loss_fn=loss_fn,
                    no_sync=no_sync)(*_tensors(_batches()[0]))
    assert calls == [False, False, False, True]


@pytest.mark.parametrize("mode,tp_size,world,ok", [
    ("dp", 1, 1, True), ("fsdp", 1, 2, True), ("tp", 2, 2, True), ("fsdp_tp", 2, 4, True),
    ("dp", 2, 4, True), ("fsdp_tp", 4, 4, True),
    ("zero3", 1, 1, False), ("tp", 3, 4, False), ("fsdp_tp", 0, 4, False),
])
def test_check_sharding(mode, tp_size, world, ok):
    """Every mode of the JAX package is accepted; an unknown mode or a
    tp_size that does not divide the world is refused."""
    from chunkformer_tpu_torch.parallel.mesh import check_sharding

    if ok:
        check_sharding(mode, tp_size, world)
    else:
        with pytest.raises(ValueError):
            check_sharding(mode, tp_size, world)
