"""Optimizer, learning-rate schedules and frozen modules (counterpart of
``chunkformer_tpu/train/optim.py``; reference chunkformer/utils/scheduler.py).

The JAX package builds ``optax.chain(clip_by_global_norm, adam|adamw)``. The
port uses ``torch.optim.AdamW`` (fused), whose arithmetic is optax's: eps
outside the square root, bias-corrected moments, and decoupled decay
``p * (1 - lr * wd)``, which equals optax's ``p - lr * (update + wd * p)``.
What torch does differently is done here:
- adamw's weight decay defaults to 0.01 (optax), applied to every trainable
  parameter;
- the schedule gives the learning rate itself (``min_lr`` is a floor on it,
  not on a factor), read at the update count before the update, as optax
  reads it: ``LambdaLR`` over a base rate of 1 starts at count 0, and only
  ``warmup_lr`` evaluates its formula at count + 1;
- clipping is ``clip_by_global_norm_``: scale by max_norm / norm only when
  norm > max_norm, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- ``freeze_modules`` leaves the frozen parameters out of the optimizer and
  the clip norm (optax's ``multi_transform`` over the whole chain).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def warmup_lr(lr: float, warmup_steps: int = 25000) -> Callable[[int], float]:
    """lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) at s = step + 1 (scheduler.py:26-75)."""

    def schedule(step: int) -> float:
        s = float(step) + 1.0
        return lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def warmup_policy(lr: float, warmup_steps: int = 0, warmup_ratio: Optional[float] = None,
                  max_steps: int = 0, min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup then constant (scheduler.py:78-144)."""
    if warmup_ratio is not None:
        warmup_steps = int(warmup_ratio * max_steps)

    def schedule(step: int) -> float:
        s = float(step)
        return lr * s / max(warmup_steps, 1) if s <= warmup_steps else max(lr, min_lr)

    return schedule


def square_root_constant_policy(lr: float, constant_steps: int = 0,
                                constant_ratio: Optional[float] = None, max_steps: int = 0,
                                min_lr: float = 0.0) -> Callable[[int], float]:
    """lr / sqrt(constant_steps) then 1/sqrt(t) decay (scheduler.py:146-209)."""
    if constant_ratio is not None:
        constant_steps = int(constant_ratio * max_steps)
    const_lr = lr * constant_steps ** -0.5 if constant_steps > 0 else lr

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        return const_lr if s <= constant_steps else max(lr * s ** -0.5, min_lr)

    return schedule


def cosine_annealing(lr: float, warmup_steps: int = 0, max_steps: int = 100000,
                     min_lr: float = 0.0) -> Callable[[int], float]:
    """Warmup + cosine decay (scheduler.py:498-551)."""

    def schedule(step: int) -> float:
        s = float(step)
        if warmup_steps > 0 and s <= warmup_steps:
            return lr * s / max(warmup_steps, 1)
        frac = min(max((s - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * frac))

    return schedule


def noam_annealing(lr: float, d_model: int = 256, warmup_steps: int = 1000,
                   min_lr: float = 0.0) -> Callable[[int], float]:
    """Noam schedule (scheduler.py:554-620)."""
    norm = d_model ** -0.5

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        out = lr * norm * min(s ** -0.5, s * warmup_steps ** -1.5)
        return max(out, min_lr) if s > warmup_steps else out

    return schedule


def noam_hold_annealing(lr: float, warmup_steps: int = 0, warmup_ratio: Optional[float] = None,
                        hold_steps: int = 0, hold_ratio: Optional[float] = None,
                        max_steps: int = 100000, decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Callable[[int], float]:
    """Warmup -> hold -> polynomial decay (scheduler.py:623-709)."""
    if warmup_ratio is not None:
        warmup_steps = int(warmup_ratio * max_steps)
    if hold_ratio is not None:
        hold_steps = int(hold_ratio * max_steps)
    hold_until = warmup_steps + hold_steps

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        if s <= warmup_steps:
            return lr * s / max(warmup_steps, 1)
        if s <= hold_until:
            return lr
        if warmup_steps > 0:
            decay_arg = max((s - hold_until + warmup_steps) / warmup_steps, 1e-8)
        else:
            decay_arg = max(s - hold_until + 1, 1.0)
        return max(lr * decay_arg ** -decay_rate, min_lr)

    return schedule


SCHEDULERS = {
    "warmuplr": warmup_lr,
    "warmup_policy": warmup_policy,
    "squarerootconstantpolicy": square_root_constant_policy,
    "cosineannealing": cosine_annealing,
    "noamannealing": noam_annealing,
    "noamholdannealing": noam_hold_annealing,
}


def build_schedule(name: str, conf: Dict[str, Any]) -> Callable[[int], float]:
    key = name if name in SCHEDULERS else name.lower()
    if key not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name}")
    return SCHEDULERS[key](**conf)


def freeze_modules(model: torch.nn.Module, patterns: Sequence[str]
                   ) -> List[torch.nn.Parameter]:
    """Freeze the parameters whose dot name contains any pattern substring
    (reference: utils/train_utils.py:897-903): they stop requiring gradients,
    so they get no update, no weight decay, no moments and no share of the
    clip norm. Returns the trainable parameters, for ``build_optimizer``."""
    pats = [p for p in patterns if p]
    trainable = []
    for name, p in model.named_parameters():
        if any(pt in name for pt in pats):
            p.requires_grad_(False)
        elif p.requires_grad:
            trainable.append(p)
    return trainable


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place; returns the norm before
    clipping. ``norm`` is the global norm where the gradients are shards
    (``parallel.mesh.Parallel.grad_norm``); a DTensor is scaled through its
    local shard."""
    grads = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm and max_norm > 0:
        torch._foreach_mul_(grads, torch.where(norm < max_norm, torch.ones_like(norm),
                                               max_norm / norm))
    return norm


def build_optimizer(params: List[torch.Tensor], optim: str, optim_conf: Dict[str, Any],
                    scheduler: str, scheduler_conf: Dict[str, Any]
                    ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """adam/adamw + schedule (reference: utils/train_utils.py:490-566).
    Returns (optimizer, lr scheduler); clipping is the train step's."""
    if optim not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optim}")
    conf = dict(optim_conf)
    lr = conf.pop("lr")
    weight_decay = conf.pop("weight_decay", 0.01 if optim == "adamw" else 0.0)
    if optim == "adam":
        weight_decay = 0.0
    betas, eps = (conf.pop("b1", 0.9), conf.pop("b2", 0.999)), conf.pop("eps", 1e-8)
    if conf:
        raise ValueError(f"unknown optimizer settings {sorted(conf)}")
    schedule = build_schedule(scheduler, {**scheduler_conf, "lr": lr})
    # base rate 1: LambdaLR's factor is the learning rate itself
    opt = torch.optim.AdamW(params, lr=1.0, betas=betas, eps=eps, weight_decay=weight_decay,
                            fused=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
