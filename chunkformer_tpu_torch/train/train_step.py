"""One training step: loss, gradients and an optimizer update (counterpart of
``chunkformer_tpu/train/train_step.py:46 make_train_step`` and
``make_eval_step``).

The step takes a batch that is already on the model's device. With
``accum_steps`` = A the batch is cut into A micro-batches along its first
axis; their gradients and metrics are averaged before one update (the JAX
``lax.scan`` over micro-batches; reference executor.py:85-98). Gradients land
in each parameter's ``.grad``, clipped in place before the update. For a
classification model ``targets`` is the {task: labels} dict.
``autocast`` = torch.bfloat16 runs the forward under ``torch.autocast`` with
f32 parameters and optimizer state. ``loss_fn`` is ``asr_model_loss`` by
default or ``transducer_model_loss``; it gets the optimizer step (the
scheduler's count of finished steps), which the transducer's warmup mixing
reads. ``no_sync`` is the context in which every micro-batch but the last
runs: DDP's ``no_sync`` or FSDP's, so that the gradients are averaged once
an update. Under a sharded placement (``parallel.mesh.Parallel``)
``reduce_grads`` averages the gradients over the data axis where no
wrapper does, and ``grad_norm`` gives their global norm for the clip.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import torch

from ..config import ChunkFormerConfig
from .losses import asr_model_loss
from .optim import clip_by_global_norm_


def _split(x, a: int):
    """``a`` micro-batches of a tensor or of a {task: labels} dict."""
    if isinstance(x, dict):
        parts = {k: v.chunk(a) for k, v in x.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(a)]
    return x.chunk(a)


def make_train_step(model: torch.nn.Module, cfg: ChunkFormerConfig,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    chunk_cfg: Tuple[int, int, int] = (0, 0, 0), accum_steps: int = 1,
                    autocast: Optional[torch.dtype] = None, grad_clip: float = 5.0,
                    loss_fn: Callable[..., Dict[str, torch.Tensor]] = asr_model_loss,
                    no_sync: Callable[[], ContextManager] = contextlib.nullcontext,
                    reduce_grads: Optional[Callable[[List[torch.Tensor]], None]] = None,
                    grad_norm: Optional[Callable[[List[torch.Tensor]], Optional[torch.Tensor]]]
                    = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(feats [A*B, T, F], feats_lens, targets, target_lens,
    generator) -> metrics (``loss_fn``'s, e.g. loss, loss_ctc, loss_att,
    acc_att, and grad_norm, step) as 0-dim tensors. ``generator`` (CPU)
    turns dropout on; None leaves it off.
    ``optimizer`` and ``scheduler`` come from ``optim.build_optimizer``; the
    gradients are clipped to a global norm of ``grad_clip`` before the update
    (``grad_norm`` is the norm before clipping).
    """
    c, left, right = chunk_cfg
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(feats, feats_lens, targets, target_lens,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        a = accum_steps
        sums: Dict[str, torch.Tensor] = {}
        ctx = (torch.autocast(feats.device.type, dtype=autocast) if autocast is not None
               else contextlib.nullcontext())
        for i, (f, fl, t, tl) in enumerate(zip(feats.chunk(a), feats_lens.chunk(a),
                                               _split(targets, a), target_lens.chunk(a))):
            with no_sync() if i < a - 1 else contextlib.nullcontext():
                with ctx:
                    metrics = loss_fn(model, cfg, f, fl, t, tl, c, left, right, train=True,
                                      generator=generator, step=scheduler.last_epoch)
                (metrics["loss"] / a).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        for p in params:  # optax updates (and decays) every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if reduce_grads is not None:
            reduce_grads(params)
        out = {k: v / a for k, v in sums.items()}
        out["grad_norm"] = clip_by_global_norm_([p.grad for p in params], grad_clip,
                                                grad_norm(params) if grad_norm else None)
        optimizer.step()
        scheduler.step()
        out["step"] = torch.tensor(scheduler.last_epoch)
        return out

    return step


def make_eval_step(model: torch.nn.Module, cfg: ChunkFormerConfig,
                   loss_fn: Callable[..., Dict[str, torch.Tensor]] = asr_model_loss):
    """Returns eval(feats, feats_lens, targets, target_lens) -> metrics, full
    context, no dropout, batch norm on running statistics."""

    @torch.no_grad()
    def eval_step(feats, feats_lens, targets, target_lens) -> Dict[str, torch.Tensor]:
        return loss_fn(model, cfg, feats, feats_lens, targets, target_lens, 0, 0, 0,
                       train=False, generator=None)

    return eval_step
