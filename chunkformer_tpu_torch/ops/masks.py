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


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunk-causal mask [size, size]: frame i sees every frame up to the end
    of its chunk, and with ``num_left_chunks`` >= 0 only that many chunks
    before its own (reference: mask.py:89)."""
    i = torch.arange(size, device=device)
    chunk_of = i // chunk_size
    mask = i[None, :] < ((chunk_of + 1) * chunk_size)[:, None]
    if num_left_chunks >= 0:
        min_visible = torch.clamp_min((chunk_of - num_left_chunks) * chunk_size, 0)
        mask = mask & (i[None, :] >= min_visible[:, None])
    return mask


def add_optional_chunk_mask(pad_mask: torch.Tensor, chunk_size: int,
                            num_left_chunks: int = -1) -> torch.Tensor:
    """A padding mask [B, 1, T] with a chunk mask -> [B, T, T]; at
    chunk_size <= 0 the padding mask of both axes (a 3-dim mask) or the mask
    as it is."""
    size = pad_mask.shape[-1]
    if chunk_size <= 0:
        return pad_mask & pad_mask.transpose(1, 2) if pad_mask.dim() == 3 else pad_mask
    return pad_mask & subsequent_chunk_mask(size, chunk_size, num_left_chunks,
                                            pad_mask.device)[None]


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
