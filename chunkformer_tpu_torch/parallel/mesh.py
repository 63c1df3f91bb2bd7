"""Data parallelism across processes (counterpart of
``chunkformer_tpu/parallel/mesh.py``; reference chunkformer/utils/train_utils.py:254-489).

The JAX package shards a (data, model) mesh with GSPMD. The port runs one
process per card (``torchrun``) and ``DistributedDataParallel`` over the
model: each process trains on its own shard of the data list and DDP
averages the gradients before the clip and the update, once an update (the
micro-batches before the last run under ``no_sync``). DDP's mean over
processes equals the JAX package's mean over the global batch only when
every process's batch has the same size, as with static batches. The
Executor pads each process's own batch to a multiple of accum_grad, which
makes its micro-batches equal but not the processes' batches: with dynamic
batching a process's mean weighs the same whatever its batch size. Only ``--sharding dp`` is ported; the fsdp, tp and fsdp_tp
modes raise.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Optional, Tuple

import torch
import torch.distributed as dist

SHARDING_MODES = ("dp", "fsdp", "tp", "fsdp_tp")


@dataclass
class DataParallel:
    """The process group as the trainer sees it."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def check_sharding(mode: str, tp_size: int = 1) -> None:
    if mode not in SHARDING_MODES:
        raise ValueError(f"unknown sharding mode {mode}")
    if mode != "dp" or tp_size > 1:
        raise NotImplementedError(
            f"--sharding {mode} --tp_size {tp_size} is not ported yet (ROADMAP A22, "
            "the fsdp / tp / fsdp_tp sharding modes); use --sharding dp")


def init_distributed(device: torch.device) -> DataParallel:
    """Join the process group that ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the card
    (cuda:LOCAL_RANK), gloo on the CPU."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if name not in os.environ:
            raise RuntimeError(f"--distributed needs {name} in the environment (torchrun sets it)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", rank=rank, world_size=world)
    return DataParallel(rank, world, device)


class _LossForward(torch.nn.Module):
    """The model under DDP: forward(...) is the loss function's call, so
    DDP's hooks see every forward and backward."""

    def __init__(self, model: torch.nn.Module, cfg, loss_fn: Callable[..., Dict]):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.loss_fn = loss_fn

    def forward(self, *args, **kwargs):
        return self.loss_fn(self.model, self.cfg, *args, **kwargs)


def loss_leaves_unused(model: torch.nn.Module, cfg) -> bool:
    """Whether the training loss can leave a parameter of ``model`` without
    a gradient, so that DDP must search the autograd graph for such
    parameters after every forward (``find_unused_parameters``). Exact for
    the hybrid CTC/AED loss: the CTC head at ctc_weight 0, the decoder at
    ctc_weight 1, the right decoder at reverse_weight 0. The transducer and
    classification losses are taken to leave some (their optional heads and
    branches)."""
    if cfg.model != "asr_model":
        return True
    mc = cfg.model_conf
    dec = model.decoder
    return mc.ctc_weight <= 0.0 or (dec is not None and (
        mc.ctc_weight >= 1.0 or (dec.right_decoder is not None and mc.reverse_weight <= 0.0)))


def ddp_loss_fn(model: torch.nn.Module, cfg, loss_fn: Callable[..., Dict],
                dp: DataParallel
                ) -> Tuple[Callable[..., Dict], Callable[[], ContextManager]]:
    """(``loss_fn`` with the same signature (model, cfg, feats, ...) run
    through ``DistributedDataParallel`` over ``model``, the context in which
    a micro-batch's forward and backward skip the gradient all-reduce). Where
    the world is one process they are ``loss_fn`` itself and a null context."""
    if dp.world <= 1 and not dist.is_initialized():
        return loss_fn, contextlib.nullcontext
    ids = [dp.device.index] if dp.device.type == "cuda" else None
    wrapped = torch.nn.parallel.DistributedDataParallel(
        _LossForward(model, cfg, loss_fn), device_ids=ids,
        find_unused_parameters=loss_leaves_unused(model, cfg))

    def run(_model, _cfg, *args, **kwargs):
        return wrapped(*args, **kwargs)

    return run, wrapped.no_sync


def all_reduce_mean(values: Dict[str, torch.Tensor], dp: Optional[DataParallel]
                    ) -> Dict[str, torch.Tensor]:
    """Mean of 0-dim metrics over the processes (the global batch's, for
    equal per-process batches)."""
    if dp is None or dp.world <= 1 or not dist.is_initialized():
        return values
    keys = sorted(values)
    t = torch.stack([values[k].float().to(dp.device) for k in keys])
    dist.all_reduce(t)
    t /= dp.world
    return dict(zip(keys, t))
