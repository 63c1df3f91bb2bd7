"""Tensor parallelism by hand over the ``model`` axis of the mesh (the
``tp`` rules of ``chunkformer_tpu/parallel/mesh.py:43-54``; the reference
has none).

A rank of a tensor-parallel group of size P keeps 1/P of the heads of every
attention and 1/P of the hidden units of every feed-forward block: the q,
k and v projections (and the encoder's positional projection and biases
u, v, which GSPMD left replicated: here each rank owns its heads'
parameters) by output rows, the output projection and the FFN's ``w_2`` by
input columns, the FFN's ``w_1`` by output rows. Everything else is
replicated. Megatron's two operators join the shards: ``copy_to_tp`` is
the identity forward and sums the input gradient over the group backward;
``row_parallel_linear`` sums the partial products over the group forward
(in float32) and adds the bias once. The ranks of a group see the same
batch and draw the same dropout masks at full width, each keeping its
slice (``nn/layers.py:dropout``'s ``shard``), and the training attention
hashes its dropout by global head (``ops/chunk_attention_train.py``), so a
step equals the single-process step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class TPShard:
    """A module's place in its tensor-parallel group."""

    group: object  # torch.distributed ProcessGroup of the model axis
    rank: int
    size: int

    def span(self, local: int) -> Tuple[int, int]:
        """(offset, full size) of this rank's ``local`` units along a split axis."""
        return self.rank * local, local * self.size


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.float().contiguous().clone()
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """The input of a column-parallel block: x forward, the gradient summed
    over the group backward (x itself without tensor parallelism)."""
    return x if tp is None else _CopyToModelGroup.apply(x, tp.group)


def row_parallel_linear(linear: nn.Linear, x: torch.Tensor,
                        tp: Optional[TPShard]) -> torch.Tensor:
    """``linear(x)`` for a weight split by input columns: the partial
    products summed over the group, then the (replicated) bias."""
    if tp is None:
        return linear(x)
    y = _ReduceFromModelGroup.apply(F.linear(x, linear.weight), tp.group)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


def _keep(param: nn.Parameter, dim: int, start: int, length: int) -> nn.Parameter:
    return nn.Parameter(param.detach().narrow(dim, start, length).clone(),
                        requires_grad=param.requires_grad)


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, tp: TPShard) -> Dict[str, int]:
    """Cut ``model``'s attentions and feed-forward blocks to this rank's
    shard in place and give them ``tp``. Returns {parameter name: the axis
    it is split on}."""
    from ..nn.attention import RelPositionMultiHeadedAttention
    from ..nn.decoder import MultiHeadedAttention
    from ..nn.layers import PositionwiseFeedForward

    split: Dict[str, int] = {}
    for prefix, module in model.named_modules():
        parts = []  # (submodule name, parameter name, axis, units per head or unit)
        if isinstance(module, (RelPositionMultiHeadedAttention, MultiHeadedAttention)):
            heads = module.heads
            d_k = module.linear_q.weight.shape[0] // heads
            if heads % tp.size:
                raise ValueError(f"{prefix}: {heads} heads do not split over {tp.size} ranks")
            n = heads // tp.size
            for lin in ("linear_q", "linear_k", "linear_v"):
                parts += [(lin, "weight", 0, n * d_k), (lin, "bias", 0, n * d_k)]
            parts.append(("linear_out", "weight", 1, n * d_k))
            if isinstance(module, RelPositionMultiHeadedAttention):
                parts += [("linear_pos", "weight", 0, n * d_k), ("", "pos_bias_u", 0, n),
                          ("", "pos_bias_v", 0, n)]
        elif isinstance(module, PositionwiseFeedForward):
            hidden = module.w_1.weight.shape[0]
            if hidden % tp.size:
                raise ValueError(f"{prefix}: {hidden} hidden units do not split over "
                                 f"{tp.size} ranks")
            n = hidden // tp.size
            parts = [("w_1", "weight", 0, n), ("w_1", "bias", 0, n), ("w_2", "weight", 1, n)]
        else:
            continue
        for sub, name, dim, n in parts:
            owner = module.get_submodule(sub) if sub else module
            setattr(owner, name, _keep(getattr(owner, name), dim, tp.rank * n, n))
            split[".".join(p for p in (prefix, sub, name) if p)] = dim
        module.tp = tp
    return split
