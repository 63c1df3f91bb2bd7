"""Core building blocks (counterpart of ``chunkformer_tpu/nn/layers.py``).

Parameter names follow the reference modules (modules/norm.py, swish.py,
positionwise_feed_forward.py), so reference state dicts load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    """RMSNorm computed in f32 (reference: modules/norm.py:4-21)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def make_norm(dim: int, norm_type: str = "layer_norm", eps: float = 1e-5) -> nn.Module:
    return RMSNorm(dim, eps) if norm_type == "rms_norm" else nn.LayerNorm(dim, eps=eps)


def activation(name: str):
    if name != "swish":
        raise ValueError(f"activation {name!r} is not supported by this package yet")
    return F.silu  # x * sigmoid(x) (reference: modules/swish.py:22)


class PositionwiseFeedForward(nn.Module):
    """w_2(act(w_1(x))) (reference: modules/positionwise_feed_forward.py:21)."""

    def __init__(self, d_model: int, hidden: int, act: str = "swish"):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden)
        self.w_2 = nn.Linear(hidden, d_model)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.act(self.w_1(x)))
