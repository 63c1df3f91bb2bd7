"""Masked-batch decode with the packed chunk rows split over processes.

``chunkformer_tpu`` shards the chunk-row axis of ``encoder_parallel_chunk``
over the ``data`` mesh axis, and GSPMD inserts the halo exchanges that its
overlapping windows need (tests/test_sharded_inference.py,
tools/bench_scaling.py). PyTorch has no GSPMD, so the exchange is written
here:

- ``pack_for_world`` packs a batch with its capacity rounded up to a
  multiple of the world size, and ``split_rows`` gives each rank a
  contiguous block of rows (``RowBlock``).
- ``exchange`` turns a rank's share of a flat stream (the attention's K/V
  rows, the conv module's GLU output) into ``[left halo | local | right
  halo]``, the stream layout the unsharded layer builds from its cache and
  zero padding, and returns the rows of the global stream that become the
  next cache, the same on every rank.
- ``gather_rows`` concatenates every rank's rows in global row order (the
  CTC tokens).

A group of one process runs the same code: the collective copies the
rank's own slab, and the stream and cache equal the unsharded layer's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.chunk import PackedChunks, pack_chunks


@dataclasses.dataclass
class RowBlock:
    """One rank's contiguous block of a packed batch's chunk rows."""

    xs: torch.Tensor         # [n_local, size, feat]
    chunk_idx: np.ndarray    # [n_local] int32
    offsets: np.ndarray      # [n_local] int32
    max_lens: np.ndarray     # [n_local] int32
    first_row: int           # global index of the block's first row


def world_capacity(rows: int, world: int) -> int:
    """``rows`` rounded up to a multiple of ``world``."""
    return -(-rows // world) * world


def pack_for_world(xs: Sequence[torch.Tensor], lengths: Sequence[int], chunk_size: int,
                   world: int, offsets: Optional[Sequence[int]] = None,
                   capacity: Optional[int] = None) -> PackedChunks:
    """``pack_chunks`` with the capacity (at least the batch's rows, or
    ``capacity`` where given) rounded up to a multiple of ``world``, so every
    rank holds the same number of rows (tools/bench_scaling.py:80-84)."""
    rows = pack_chunks(xs, lengths, chunk_size, offsets=offsets).xs.shape[0]
    cap = world_capacity(max(rows, capacity or 0), world)
    return pack_chunks(xs, lengths, chunk_size, offsets=offsets, capacity=cap)


def split_rows(packed: PackedChunks, rank: int, world: int) -> RowBlock:
    """Rank ``rank``'s block of ``packed``'s rows: rows [rank * n, (rank + 1) * n)
    with n = capacity / world. Ranks past the batch's last row hold only
    capacity-padding rows (zero features, zero metadata)."""
    cap = packed.xs.shape[0]
    if cap % world:
        raise ValueError(f"capacity {cap} is not a multiple of the world size {world}")
    n = cap // world
    lo, hi = rank * n, (rank + 1) * n
    return RowBlock(packed.xs[lo:hi], packed.chunk_idx[lo:hi], packed.offsets[lo:hi],
                    packed.max_lens[lo:hi], lo)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[world, *t.shape]: ``t`` of every rank of ``group``, in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows ``t`` [n_local, ...] as [world * n_local, ...] in
    global row order, on every rank."""
    return _all_gather(t, group).flatten(0, 1)


def exchange(local: torch.Tensor, fill: torch.Tensor, right: int, group,
             keep: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stream rows around this rank's share of a flat stream.

    Every rank holds m = ``local.shape[0]`` consecutive rows of a global
    stream; rank r holds its rows [r*m, (r+1)*m). With l = ``fill.shape[0]``
    the global stream is G = [fill | rank 0's rows | ... | rank W-1's rows |
    ``right`` zero rows]. Returns (the rows of G from l before this rank's
    first row to ``right`` after its last, [l + m + right, ...]; rows
    [start, start + count) of G for ``keep`` = (start, count), the same
    tensor on every rank). On rank 0 the left halo is ``fill``; on the last
    rank the right halo is zeros. Where m < l or m < ``right`` a halo spans
    several ranks; a rank whose rows are all capacity padding exchanges
    them like any other.

    One ``all_gather`` a call carries each rank's last min(m, l) rows, its
    first min(m, right) rows and its part of the kept span (zeros where
    another rank or the fill holds it). A pair of point-to-point sends
    (``batch_isend_irecv``) to the two neighbours would move fewer bytes,
    but a halo longer than a shard needs rows from ranks further away, and
    the kept rows can lie on any rank, so every split would need its own
    plan of sends; the gather's shapes are fixed by m, l, ``right`` and
    ``count`` alone, and at a world of one it is a copy of the rank's own
    slab, so one process runs this same code. Each rank receives W times
    its slab: at ChunkFormer-large (L = R = 128 rows of 8 heads x 128) and
    W = 8 that is 6.3 MB a layer in bf16.
    """
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    m, left = local.shape[0], fill.shape[0]
    start, count = keep
    if fill.shape[1:] != local.shape[1:] or fill.dtype != local.dtype:
        raise ValueError(f"fill {tuple(fill.shape)} {fill.dtype} does not match the "
                         f"local rows {tuple(local.shape)} {local.dtype}")
    if start < 0 or count < 0 or start + count > left + world * m + right:
        raise ValueError(f"rows [{start}, {start + count}) outside the global stream of "
                         f"{left + world * m + right}")
    rest = local.shape[1:]
    n_tail, n_head = min(m, left), min(m, right)

    def owned(r: int) -> Tuple[int, int]:
        """The kept span's rows that rank r holds, as G row indices [a, b)."""
        first = left + r * m
        return max(start, first), min(start + count, first + m)

    kept_part = local.new_zeros((count, *rest))
    a, b = owned(rank)
    if a < b:
        first = left + rank * m
        kept_part[a - start:b - start] = local[a - first:b - first]
    slab = torch.cat([local[m - n_tail:], local[:n_head], kept_part])
    # [W, n_tail + n_head + count, ...]; nothing to send where L = R = 0
    gathered = (_all_gather(slab, group) if slab.numel()
                else slab.new_empty((world, *slab.shape)))

    zeros = local.new_zeros((right, *rest))
    tails = gathered[:rank, :n_tail].reshape(-1, *rest)  # ranks before this one
    heads = gathered[rank + 1:, n_tail:n_tail + n_head].reshape(-1, *rest)
    before = torch.cat([fill, tails])
    stream = torch.cat([before[before.shape[0] - left:], local,
                        torch.cat([heads, zeros])[:right]])

    parts = [fill[start:min(start + count, left)]]
    for r in range(world):
        a, b = owned(r)
        if a < b:
            k = n_tail + n_head + a - start
            parts.append(gathered[r, k:k + b - a])
    end = left + world * m
    parts.append(zeros[:max(0, start + count - max(start, end))])
    return stream, torch.cat(parts)
