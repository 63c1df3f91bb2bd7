"""Mask constructors (copy of ``chunkformer_tpu/ops/masks.py``; reference
chunkformer/utils/mask.py). Boolean, True = valid, except where a function
says otherwise."""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at valid positions: [B] -> [B, max_len]."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [size, size] (reference: mask.py:53)."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]


def mask_finished_scores(scores: torch.Tensor, finished: torch.Tensor, eos: int) -> torch.Tensor:
    """For finished beams [B] force the EOS score to 0 and every other to the
    dtype's lowest value (reference: mask.py:257)."""
    neg = torch.finfo(scores.dtype).min
    is_eos = torch.arange(scores.shape[-1], device=scores.device)[None, :] == eos
    fin = finished[:, None]
    return torch.where(fin & is_eos, torch.zeros((), dtype=scores.dtype, device=scores.device),
                       torch.where(fin & ~is_eos, torch.full((), neg, dtype=scores.dtype,
                                                             device=scores.device), scores))


def mask_finished_preds(preds: torch.Tensor, finished: torch.Tensor, eos: int) -> torch.Tensor:
    """Force the EOS prediction for finished beams (reference: mask.py:284)."""
    return torch.where(finished[:, None], torch.full_like(preds, eos), preds)
