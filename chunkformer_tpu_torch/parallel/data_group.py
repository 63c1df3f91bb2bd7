"""Statistics over the data axis of a data-parallel run.

The JAX package computes a step over the global batch under GSPMD, so its
batch-norm statistics, its length-normalized attention loss and its token
accuracy are taken over every process's rows at once. A port process holds
only its share of each micro-batch; the modules and losses that need the
global figure sum their own over the data group here. ``Parallel``
(``parallel/mesh.py``) hands the group to the model with
``set_data_group`` where the data axis is above 1; otherwise it stays None
and every caller takes its single-process path, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def active(group: Optional[object]) -> bool:
    """Whether ``group`` spans more than one process."""
    return group is not None and dist.get_world_size(group) > 1


@torch.no_grad()
def count_over(x: torch.Tensor, group: object) -> torch.Tensor:
    """Σ x over the group, in float32, outside autograd (counts)."""
    total = x.detach().float().clone()
    dist.all_reduce(total, group=group)
    return total


def set_data_group(model: torch.nn.Module, group: Optional[object]) -> None:
    """Give ``model`` and each of its modules that carries a ``data_group``
    (the batch-norm conv modules, the models whose losses read it) the
    process group of the data axis."""
    for module in model.modules():
        if hasattr(module, "data_group"):
            module.data_group = group
