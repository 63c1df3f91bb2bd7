"""Label helpers for the attention loss (copy of ``chunkformer_tpu/ops/common.py``;
reference chunkformer/utils/common.py), shape-static and mask-driven."""

from __future__ import annotations

from typing import Tuple

import torch

IGNORE_ID = -1


def add_sos_eos(ys_pad: torch.Tensor, ys_lens: torch.Tensor, sos: int, eos: int,
                ignore_id: int = IGNORE_ID) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder input and output (reference common.py:98-136). ys_pad [B, U]
    padded with ignore_id. Returns ys_in [B, U+1]: sos y1..yU (pad -> eos),
    ys_out [B, U+1]: y1..yU eos (pad -> ignore_id)."""
    b, u = ys_pad.shape
    idx = torch.arange(u + 1, device=ys_pad.device)[None, :]
    lens = ys_lens[:, None]
    y = ys_pad.masked_fill(ys_pad == ignore_id, eos)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=ys_pad.dtype, device=ys_pad.device), y], 1)
    ys_in = ys_in.masked_fill(idx > lens, eos)
    labels = torch.cat([ys_pad, torch.full((b, 1), ignore_id, dtype=ys_pad.dtype,
                                           device=ys_pad.device)], 1)
    ys_out = torch.where(idx < lens, labels, torch.where(idx == lens, eos, ignore_id))
    return ys_in, ys_out.to(ys_pad.dtype)


def reverse_pad_list(ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: int = IGNORE_ID) -> torch.Tensor:
    """Per-row reversal of the valid prefix (reference common.py:139-164)."""
    u = ys_pad.shape[1]
    rev = ys_lens[:, None] - 1 - torch.arange(u, device=ys_pad.device)[None, :]
    gathered = torch.gather(ys_pad, 1, rev.clamp_min(0).long())
    return gathered.masked_fill(rev < 0, pad_value)


def th_accuracy(logits: torch.Tensor, target: torch.Tensor,
                ignore_label: int = IGNORE_ID) -> torch.Tensor:
    """Token accuracy over non-ignored targets (reference common.py:167-198)."""
    mask = target != ignore_label
    correct = ((logits.argmax(-1) == target) & mask).sum()
    return correct / mask.sum().clamp_min(1)
