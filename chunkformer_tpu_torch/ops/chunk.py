"""Chunk decomposition: packing arithmetic, boundary masks, segment gathers.

Counterpart of ``chunkformer_tpu/ops/chunk.py`` (reference:
chunkformer/modules/encoder.py:503-645). Chunk rows are overlapping windows
of ``size = (c-1)*sub + 15`` raw frames with step ``sub*c``; each row carries
three integers: its chunk index within the utterance, the utterance's global
decode offset and its valid subsampled length. Window position p of chunk i
covers subsampled frame f = i*c - L + p (attention) or i*c - lorder + p
(conv), valid iff -offset <= f < max_len; conv additionally caps the right
context at f - i*c <= c - 1 + R.

Rows are cut with ``Tensor.unfold`` on whatever device holds the features;
the per-row integers stay numpy arrays on the host until the encoder call.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SUBSAMPLING_CONTEXT = 15  # embed.right_context + 1 (reference: subsampling.py:45, encoder.py:539)


def calc_length(length, sampling_num: int = 3, kernel_size: int = 3, stride: int = 2):
    """Output length after the stride-2 conv stack (reference: subsampling.py:270-288)."""
    length = np.asarray(length, dtype=np.float64)
    for _ in range(sampling_num):
        length = np.floor((length - kernel_size) / stride + 1.0)
    return length.astype(np.int64)


def reverse_calc_length(out_length: int, sampling_num: int = 3, kernel_size: int = 3,
                        stride: int = 2) -> int:
    """Input length that yields `out_length` (reference: subsampling.py:290-311)."""
    length = out_length
    for _ in range(sampling_num):
        length = length * stride - stride + kernel_size
    return length if out_length > 0 else 0


@dataclasses.dataclass
class PackedChunks:
    """A batch of utterances cut into chunk rows."""

    xs: torch.Tensor         # [N, size, feat] chunk rows (N padded to capacity)
    chunk_idx: np.ndarray    # [N] int32 — chunk index within its utterance
    offsets: np.ndarray      # [N] int32 — utterance global decode offset (subsampled frames)
    max_lens: np.ndarray     # [N] int32 — valid subsampled frames of the utterance
    valid: np.ndarray        # [N] bool — False for capacity-padding rows
    n_chunks: List[int]      # per-utterance chunk counts (for unpacking)
    out_lens: np.ndarray     # [B] int64 — per-utterance subsampled output lengths


def _rows(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """[T, feat] -> [n, size, feat] overlapping windows (a view)."""
    return x.unfold(0, size, step).transpose(1, 2)


def pack_chunks(
    xs: Sequence[torch.Tensor],
    lengths: Sequence[int],
    chunk_size: int,
    subsampling: int = 8,
    context: int = SUBSAMPLING_CONTEXT,
    offsets: Sequence[int] | None = None,
    capacity: int | None = None,
) -> PackedChunks:
    """Decompose utterances [T_i, feat] into fixed-size overlapping chunk rows.

    Mirrors reference encoder.py:553-612: tail padding with zeros so every
    row is full-width; rows past the utterances (up to ``capacity``) are zero
    with all-zero metadata.
    """
    size = (chunk_size - 1) * subsampling + context
    step = subsampling * chunk_size
    if offsets is None:
        offsets = [0] * len(xs)

    rows, chunk_idx, offs_arr, max_lens, n_chunks = [], [], [], [], []
    for x, length, offs in zip(xs, lengths, offsets):
        x = x[:length]
        t = x.shape[0]
        n_pad = (step - ((t - size) % step)) % step if t >= size else size - t
        x = F.pad(x, (0, 0, 0, n_pad))
        n_chunk = (x.shape[0] - size) // step + 1
        rows.append(_rows(x, size, step))
        chunk_idx.append(np.arange(n_chunk, dtype=np.int32))
        offs_arr.append(np.full(n_chunk, offs, dtype=np.int32))
        max_lens.append(np.full(n_chunk, 1 + (length - context) // subsampling, dtype=np.int32))
        n_chunks.append(int(n_chunk))

    n_total = sum(n_chunks)
    cap = capacity or n_total
    if cap < n_total:
        raise ValueError(f"capacity {cap} < total chunks {n_total}")
    packed = xs[0].new_zeros((cap, size, xs[0].shape[-1]))
    packed[:n_total] = torch.cat(rows, dim=0)

    def pad(parts, dtype):
        out = np.zeros(cap, dtype=dtype)
        out[:n_total] = np.concatenate(parts)
        return out

    valid = np.zeros(cap, dtype=bool)
    valid[:n_total] = True
    return PackedChunks(packed, pad(chunk_idx, np.int32), pad(offs_arr, np.int32),
                        pad(max_lens, np.int32), valid, n_chunks,
                        calc_length(np.asarray(lengths)))


def device_pack_segment(
    feats: torch.Tensor,
    start_raw: int,
    chunk_size: int,
    subsampling: int = 8,
    capacity: int = 1,
    context: int = SUBSAMPLING_CONTEXT,
) -> torch.Tensor:
    """One macro-segment's chunk rows from a zero-padded feature buffer.

    Row i covers raw frames ``[start_raw + i*sub*c, start_raw + i*sub*c + size)``
    of ``feats`` [T_pad, feat], which must hold them all and be zero past the
    audio end, so tail rows equal ``pack_chunks``'s zero padding.
    Returns [capacity, size, feat] (a view of ``feats``).
    """
    size = (chunk_size - 1) * subsampling + context
    step = subsampling * chunk_size
    span = (capacity - 1) * step + size
    if start_raw < 0 or start_raw + span > feats.shape[0]:
        raise ValueError(f"segment [{start_raw}, {start_raw + span}) outside buffer "
                         f"of {feats.shape[0]} frames")
    return _rows(feats[start_raw:start_raw + span], size, step)


def parallel_chunk_att_mask(chunk_idx: torch.Tensor, offsets: torch.Tensor,
                            max_lens: torch.Tensor, chunk_size: int,
                            left_context: int, right_context: int) -> torch.Tensor:
    """Attention validity mask [N, 1, L+c+R] for packed chunk rows."""
    p = torch.arange(left_context + chunk_size + right_context, device=chunk_idx.device)
    f = chunk_idx[:, None] * chunk_size - left_context + p[None, :]
    valid = (f >= -offsets[:, None]) & (f < max_lens[:, None])
    return valid[:, None, :]


def parallel_chunk_conv_mask(chunk_idx: torch.Tensor, offsets: torch.Tensor,
                             max_lens: torch.Tensor, chunk_size: int,
                             conv_lorder: int, right_context: int) -> torch.Tensor:
    """Conv validity mask [N, 1, c+2*lorder] for packed chunk rows."""
    rel = torch.arange(-conv_lorder, chunk_size + conv_lorder, device=chunk_idx.device)
    f = chunk_idx[:, None] * chunk_size + rel[None, :]
    valid = (f >= -offsets[:, None]) & (f < max_lens[:, None])
    valid = valid & (rel <= chunk_size - 1 + right_context)[None, :]
    return valid[:, None, :]
