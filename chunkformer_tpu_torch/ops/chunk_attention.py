"""Masked-batch relative-position chunk attention: CUDA kernel and plain version.

Counterpart of ``chunkformer_tpu/ops/pallas/chunk_attention.py``: one function
covers the union/head-major kernel (:335), its row-major wrapper (:306) and
the per-chunk and G-batched kernels (:32, :158). For chunk row i the keys are
the KV stream rows ``[i*c, i*c + L + c + R)`` (the stream carries the L-row
cache prefix and R zero rows at the end):

    scores = ((q + u) K^T + relshift((q + v) P^T)) / sqrt(dk)
    relshift: out[r, j] = bd[r, c - 1 - r + j]
    valid iff -offset <= chunk_idx*c - L + j < max_len;  softmax;  . V

Shapes are given row-major — q [N, c, H, dk], kv [L + N*c + R, H, 2dk],
p [2c - 1 + L + R, H, dk], u and v [H, dk] — but any strides with a
contiguous last axis are taken, so the head-major tensors of the TPU
contract (q [N, H, c, dk], kv [H, T, 2dk], p [H, P, dk]) are passed as
``transpose`` views without a copy. The result is [N, c, H, dk].

Three hand-written kernels compute it on the card, and ``route`` picks a
route from dtype, shapes and strides alone:

- the tensor-core route, for f32 or bf16 with head_dim 64 or 128 and
  16-byte-aligned rows at any chunk size, as the main path gives it
  (ChunkFormer-large: dk = 64, c = 64) and as any ``--chunk_size`` does:
  ``csrc/chunk_attention_tc.cu`` in bf16 and ``csrc/chunk_attention_tc_f32.cu``
  in f32 (one C entry picks by dtype). A block takes a tile of 64 query
  rows, ceil(c / 64) tiles a chunk; the last tile's rows past the chunk
  load as zeros and are not stored. wgmma products with the split bias
  form, an online softmax in registers, cp.async tiles. The f32 kernel
  splits each operand into two TF32 parts (hi + lo) and sums three TF32
  products (hi.lo + lo.hi + hi.hi): about 21 mantissa bits, which holds
  the f32 1e-5 bar that one TF32 product (10 bits) cannot.
- ``csrc/chunk_attention.cu`` (CUDA-core route): other head dims and rows
  off the 16-byte grid, f32 or bf16. Products in f32 on CUDA cores from
  shared memory. Any chunk: a block takes at most 4096 / dk query rows,
  and a third grid axis covers the rest of the chunk
  (``cuda_core_slices``).

At the ChunkFormer-large segment (N = 209, H = 8) a bf16 call moves about
55 MB, 16.6 us at 3.35 TB/s, and is bound by bytes; an f32 call's split
products (39 GFLOP of TF32) bind it by operations at about 79 us. Each
route counts its launches: ``chunk_attention.launches`` (CUDA-core) and
``chunk_attention.tc_launches`` (tensor-core, both dtypes).
"""

from __future__ import annotations

import math

import torch

from . import kernels
from .chunk import parallel_chunk_att_mask
from .relshift import rel_shift

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a boolean validity mask (True = valid);
    fully-masked rows give all-zero weights (reference attention.py:129-136)."""
    s = scores.float().masked_fill(~mask, -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~mask, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def chunk_attention_plain(q, kv, p, u, v, chunk_idx, offsets, max_lens, *,
                          chunk: int, left: int, right: int) -> torch.Tensor:
    """Plain PyTorch version, in f32 with the exact post-product 1/sqrt(dk)."""
    n, c, heads, d_k = q.shape
    w = left + c + right
    f = torch.float32
    win = kv.float().unfold(0, w, c)[:n]                # [N, H, 2dk, W]
    k, vals = win[:, :, :d_k], win[:, :, d_k:]
    qf = q.float()
    ac = torch.einsum("nchd,nhdw->nhcw", qf + u.to(f), k)
    bd = torch.einsum("nchd,phd->nhcp", qf + v.to(f), p.float())
    scores = (ac + rel_shift(bd, left, right)) / math.sqrt(d_k)
    mask = parallel_chunk_att_mask(chunk_idx.long(), offsets.long(), max_lens.long(),
                                   c, left, right)
    attn = masked_softmax(scores, mask[:, :, None, :])  # [N, H, c, W]
    return torch.einsum("nhcw,nhdw->nchd", attn, vals).to(q.dtype)


def _check(q, kv, p, u, v, meta, chunk, left, right):
    n, c, heads, d_k = q.shape
    if c != chunk:
        raise ValueError(f"q has {c} rows per chunk, expected {chunk}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"chunk_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("kv", kv), ("p", p), ("u", u), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
    for name, t in (("chunk_idx", meta[0]), ("offsets", meta[1]), ("max_lens", meta[2])):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() \
                or t.device != q.device:
            raise TypeError(f"{name} must be a contiguous int32 [N] tensor on {q.device}")
    if kv.shape != (left + n * c + right, heads, 2 * d_k):
        raise ValueError(f"kv shape {tuple(kv.shape)} != {(left + n * c + right, heads, 2 * d_k)}")
    if p.shape != (2 * c - 1 + left + right, heads, d_k):
        raise ValueError(f"p shape {tuple(p.shape)} != {(2 * c - 1 + left + right, heads, d_k)}")
    if u.shape != (heads, d_k) or v.shape != (heads, d_k) or not (
            u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u and v must be contiguous [H, dk]")
    if q.stride(-1) != 1 or kv.stride(-1) != 1 or p.stride(-1) != 1:
        raise ValueError("q, kv and p need a contiguous last axis")


def route(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor) -> str:
    """Which kernel a CUDA call launches, from dtype, shapes and strides
    alone: "tensor_core" for f32 or bf16 with head_dim 64 or 128 and every
    row of q, kv and p 16-byte aligned (the kernels copy 16 bytes a thread),
    at any chunk size; "cuda_core" otherwise."""
    if q.dtype not in _DTYPES or q.shape[-1] not in (64, 128):
        return "cuda_core"
    per16 = 16 // q.element_size()
    for t in (q, kv, p):
        if t.data_ptr() % 16 != 0 or any(s % per16 != 0 for s in t.stride()[:-1]):
            return "cuda_core"
    return "tensor_core"


def _launch(entry: str, lead: tuple, q, kv, p, u, v, chunk_idx, offsets, max_lens, *,
            chunk: int, left: int, right: int) -> torch.Tensor:
    """Check the operands and call the C entry ``entry`` with ``lead`` before
    the shared pointer, shape and stride arguments."""
    if q.device.type != "cuda":
        raise ValueError(f"the chunk attention kernels run on cuda, not {q.device}")
    _check(q, kv, p, u, v, (chunk_idx, offsets, max_lens), chunk, left, right)
    n, c, heads, d_k = q.shape
    out = torch.empty((n, c, heads, d_k), dtype=q.dtype, device=q.device)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            *lead, q.data_ptr(), kv.data_ptr(), p.data_ptr(), u.data_ptr(),
            v.data_ptr(), chunk_idx.data_ptr(), offsets.data_ptr(), max_lens.data_ptr(),
            out.data_ptr(), n, heads, c, d_k, left, right,
            q.stride(0), q.stride(1), q.stride(2), kv.stride(0), kv.stride(1),
            p.stride(0), p.stride(1), out.stride(0), out.stride(1), out.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, entry)
    return out


def cuda_core_slices(chunk: int, d_k: int) -> int:
    """Blocks a chunk takes in the CUDA-core kernels (``slices_of`` in
    ``csrc/chunk_attention.cu`` and ``csrc/chunk_attention_train.cu``): a
    thread keeps at most 16 outputs, so a block computes at most 4096 / dk
    query rows."""
    most = 4096 // d_k
    return -(-chunk // most)


def chunk_attention_cuda_core(q, kv, p, u, v, chunk_idx, offsets, max_lens, *, chunk: int,
                              left: int, right: int) -> torch.Tensor:
    """Launch the CUDA-core kernel (``csrc/chunk_attention.cu``) on CUDA tensors."""
    out = _launch("cf_chunk_attention", (_DTYPES[q.dtype],), q, kv, p, u, v, chunk_idx,
                  offsets, max_lens, chunk=chunk, left=left, right=right)
    chunk_attention.launches += 1
    return out


def chunk_attention_tensor_core(q, kv, p, u, v, chunk_idx, offsets, max_lens, *, chunk: int,
                                left: int, right: int) -> torch.Tensor:
    """Launch the tensor-core kernel of q's dtype (``csrc/chunk_attention_tc.cu``
    for bf16, ``csrc/chunk_attention_tc_f32.cu`` for f32) on CUDA tensors
    that ``route`` sends to it; raises on any other."""
    if route(q, kv, p) != "tensor_core":
        raise ValueError("the tensor-core kernels take f32 or bf16, head_dim 64 or 128 and "
                         "16-byte-aligned rows")
    out = _launch("cf_chunk_attention_tc", (_DTYPES[q.dtype],), q, kv, p, u, v, chunk_idx,
                  offsets, max_lens, chunk=chunk, left=left, right=right)
    chunk_attention.tc_launches += 1
    return out


def chunk_attention(q, kv, p, u, v, chunk_idx, offsets, max_lens, *,
                    chunk: int, left: int, right: int) -> torch.Tensor:
    """Chunk attention context [N, c, H, dk] (see the module docstring).

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernel that ``route`` names, or raises.
    """
    if q.device.type == "cpu":
        return chunk_attention_plain(q, kv, p, u, v, chunk_idx, offsets, max_lens,
                                     chunk=chunk, left=left, right=right)
    launch = (chunk_attention_tensor_core if route(q, kv, p) == "tensor_core"
              else chunk_attention_cuda_core)
    return launch(q, kv, p, u, v, chunk_idx, offsets, max_lens, chunk=chunk, left=left,
                  right=right)


chunk_attention.launches = 0     # CUDA-core kernel launches since the last reset
chunk_attention.tc_launches = 0  # tensor-core launches (both dtypes) since the last reset
