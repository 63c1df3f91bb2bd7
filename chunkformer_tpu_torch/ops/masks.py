"""Mask constructors (copy of ``chunkformer_tpu/ops/masks.py``; reference
chunkformer/utils/mask.py). Boolean, True = valid."""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at valid positions: [B] -> [B, max_len]."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [size, size] (reference: mask.py:53)."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]
