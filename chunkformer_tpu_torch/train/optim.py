"""Optimizer and learning-rate schedule (counterpart of
``chunkformer_tpu/train/optim.py``: ``warmup_lr`` :20, ``build_schedule``,
``build_optimizer`` :150).

The JAX package builds ``optax.chain(clip_by_global_norm, adam|adamw)``. The
port uses ``torch.optim.AdamW`` (fused), whose arithmetic is optax's: eps
outside the square root, bias-corrected moments, and decoupled decay
``p * (1 - lr * wd)``, which equals optax's ``p - lr * (update + wd * p)``.
What torch does differently is done here:
- adamw's weight decay defaults to 0.01 (optax), applied to every parameter;
- the schedule is read at the update count before the update (``LambdaLR``
  starts at 0; warmup_lr evaluates its formula at count + 1);
- clipping is ``clip_by_global_norm_``: scale by max_norm / norm only when
  norm > max_norm, with no epsilon (``clip_grad_norm_`` adds 1e-6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def warmup_lr(lr: float, warmup_steps: int = 25000) -> Callable[[int], float]:
    """lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) at s = step + 1 (scheduler.py:26-75)."""

    def schedule(step: int) -> float:
        s = float(step) + 1.0
        return lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


SCHEDULERS = {"warmuplr": warmup_lr}


def build_schedule(name: str, conf: Dict[str, Any]) -> Callable[[int], float]:
    key = name if name in SCHEDULERS else name.lower()
    if key not in SCHEDULERS:
        raise ValueError(f"scheduler {name!r} is not ported yet")
    return SCHEDULERS[key](**conf)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place; returns the norm before clipping."""
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
    factor = build_schedule(scheduler, {**scheduler_conf, "lr": 1.0})
    opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                            fused=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
