"""Core building blocks (counterpart of ``chunkformer_tpu/nn/layers.py``).

Parameter names follow the reference modules (modules/norm.py, swish.py,
positionwise_feed_forward.py), so reference state dicts load as they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_group import active
from ..parallel.tensor_parallel import copy_to_tp, row_parallel_linear


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


# chunkformer_tpu/nn/layers.py:148-155; swish is x * sigmoid(x) (modules/swish.py:22),
# and jax.nn.gelu's default is the tanh form
_ACTIVATIONS = {
    "swish": F.silu,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "hardtanh": F.hardtanh,  # clips to [-1, 1]
    "tanh": torch.tanh,
    "selu": F.selu,
}


def activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"activation {name!r} is not supported by this package yet")
    return _ACTIVATIONS[name]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout (``chunkformer_tpu/nn/layers.py:158``); the identity
    when ``generator`` is None (eval) or the rate is 0. The mask is drawn from
    ``generator``, which the caller seeds, so a recompute that re-seeds it
    draws the same mask. ``shard`` = (axis, offset, full size) marks x as a
    tensor-parallel slice of a wider tensor: the mask is drawn at full width
    and sliced, so each rank keeps the single-process mask of its slice."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        shape[shard[0]] = shard[2]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(shard[0], shard[1], x.shape[shard[0]])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class LSTMWeights(nn.Module):
    """The parameters of a stack of LSTM layers under ``torch.nn.LSTM``'s
    names (``weight_ih_l{i}`` [4H, in], ``weight_hh_l{i}`` [4H, H],
    ``bias_ih_l{i}``, ``bias_hh_l{i}`` [4H]; gate order i, f, g, o), drawn as
    ``nn.LSTM`` draws them, for a model that runs the cells one at a time."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        bound = hidden_size ** -0.5
        for i in range(num_layers):
            for name, shape in (("weight_ih", (4 * hidden_size, hidden_size if i else input_size)),
                                ("weight_hh", (4 * hidden_size, hidden_size)),
                                ("bias_ih", (4 * hidden_size,)), ("bias_hh", (4 * hidden_size,))):
                self.register_parameter(f"{name}_l{i}",
                                        nn.Parameter(torch.empty(shape).uniform_(-bound, bound)))

    def cell(self, i: int, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """Layer ``i``'s cell: (h, c) [B, H] after input x [B, in]."""
        return torch.lstm_cell(x, (h, c), getattr(self, f"weight_ih_l{i}"),
                               getattr(self, f"weight_hh_l{i}"), getattr(self, f"bias_ih_l{i}"),
                               getattr(self, f"bias_hh_l{i}"))


def batch_norm_train(norm: nn.BatchNorm1d, x: torch.Tensor, channel_axis: int = 1,
                     momentum: float = 0.1, group: Optional[object] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode BatchNorm from batch statistics, in f32
    (``chunkformer_tpu/nn/layers.py:121``). Returns (y, new running stats);
    the module's buffers are left as they are, as the JAX function leaves them.
    With a data ``group`` of more than one process the statistics are those
    of the group's rows together, as GSPMD takes them over the global batch:
    each channel's sum, sum of squares and the row count are summed over the
    group (differentiably), and the running variance's correction uses the
    global count."""
    axes = tuple(i for i in range(x.ndim) if i != channel_axis)
    xf = x.float()
    count = x.numel() // x.shape[channel_axis]
    if active(group):
        from torch.distributed.nn.functional import all_reduce  # differentiable

        c = x.shape[channel_axis]
        sums = all_reduce(torch.cat([xf.sum(axes), xf.square().sum(axes),
                                     xf.new_full((1,), count)]), group=group)
        mean = sums[:c] / sums[-1]
        var = sums[c:2 * c] / sums[-1] - mean.square()
        count = sums[-1].detach()
        count_less_one = (count - 1).clamp_min(1)
    else:
        mean = xf.mean(axes)
        var = xf.square().mean(axes) - mean.square()
        count_less_one = max(count - 1, 1)
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    inv = torch.rsqrt(var + norm.eps) * norm.weight.float()
    y = (xf - mean.view(shape)) * inv.view(shape) + norm.bias.float().view(shape)
    with torch.no_grad():
        stats = {"mean": (1 - momentum) * norm.running_mean + momentum * mean,
                 "var": (1 - momentum) * norm.running_var
                 + momentum * var * count / count_less_one}
    return y.to(x.dtype), stats


class PositionwiseFeedForward(nn.Module):
    """w_2(act(w_1(x))) (reference: modules/positionwise_feed_forward.py:21).
    Under tensor parallelism (``tp``, set by
    ``parallel.tensor_parallel.apply_tensor_parallel``) it holds a slice of
    the hidden units."""

    def __init__(self, d_model: int, hidden: int, act: str = "swish"):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden)
        self.w_2 = nn.Linear(hidden, d_model)
        self.act = activation(act)
        self.tp = None

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.act(self.w_1(copy_to_tp(x, self.tp)))
        shard = None if self.tp is None else (-1, *self.tp.span(h.shape[-1]))
        return row_parallel_linear(self.w_2, dropout(h, drop_rate, generator, shard), self.tp)

