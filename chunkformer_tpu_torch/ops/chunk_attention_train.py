"""Limited-context training attention with a hand-written backward: CUDA
kernels (``csrc/chunk_attention_train.cu``) and their plain versions.

Counterpart of ``chunkformer_tpu/ops/pallas/chunk_attention_train.py``: the
forward ``_attn_fwd_call`` (:316) and the backward ``_attn_core_bwd`` (:390).
The operands are built by ``RelPositionMultiHeadedAttention.chunked_train``
(as ``nn/attention.py:142 attention_chunked_train_pallas`` builds them):

    q   [B, n*c, H, dk]          queries of the padded utterances
    kv  [B, L + n*c + R, H, 2dk] fused K|V stream, L zero rows ahead, R behind
    p   [2c - 1 + L + R, H, dk]  projected positional encodings
    u, v [H, dk]                 positional biases
    lens [B] int32               valid (subsampled) frames per utterance

For query frame ci*c + r of utterance b and window position j < W = L + c + R
(key stream row ci*c + j, key frame f = ci*c - L + j):

    s[r, j] = ((q + u) . k[j] + (q + v) . p[c - 1 - r + j]) / sqrt(dk)
    valid   iff 0 <= f < lens[b] and ci*c + r < lens[b]
    m = max(max_j s, -1e29), den = max(sum_j exp(s - m), 1e-30)  (valid j only)
    ctx[r] = sum_j keep(j) / (1 - p_drop) * exp(s[r, j] - m) / den * v[j]

m and den are [B, H, n*c] float32. A query row at or past its length has an
empty key interval, so its ctx is 0.

Dropout: ``keep`` is a counter-based hash of (seed, b, h, query frame, key
stream row), a function of absolute positions only, so the forward, the
backward, any recompute and the plain version regenerate the same mask. The
TPU kernel's PRNG stream has no counterpart; the Bernoulli(1 - p) law is the
same. Under tensor parallelism a rank holds heads [h0, h0 + H) of Ht: every
entry takes ``head_offset`` = h0 and ``heads_total`` = Ht (0 = H), used only
in the hash (b * Ht + h0 + h), so a rank draws the full run's mask of its
heads; the defaults leave the mask of one process as it was.

The forward and backward are custom operators (``torch.library``), so a
selective-checkpoint policy can name the forward's outputs (the encoder's
``remat_policy: "dots"``). On a CPU tensor each runs its plain version; on a
CUDA tensor it launches the kernels of the route that ``route`` picks from
dtype, shapes and strides alone, or raises:

- the tensor-core route: f32 or bf16 with head_dim 64 or 128, any chunk
  size and 16-byte-aligned rows, as the main path gives it (the flagship
  step: dk = 64, c = 64); a chunk that 64 does not divide ends in a partial
  64-row query block, and n*c frames that 64 does not divide in a partial
  64-frame key block. ``csrc/chunk_attention_train_tc.cu``
  in bf16 and ``csrc/chunk_attention_train_tc_f32.cu`` in f32 (one C entry
  a direction picks by dtype): wgmma products, the decode kernel's staged
  rel-shift, a deterministic FlashAttention-2 backward; in f32 every
  product is split into three TF32 passes (hi.lo + lo.hi + hi.hi), about
  21 mantissa bits, which holds the f32 bars that one TF32 pass (10 bits)
  cannot. Counters ``chunk_train_attention.fwd_tc_launches`` and
  ``.bwd_tc_launches`` (both dtypes).
- ``csrc/chunk_attention_train.cu`` (CUDA-core route): the other head
  dims and strides, f32 or bf16, any chunk (slices of at most 4096 / dk
  query rows a block, ``cuda_core_slices``). Counters
  ``chunk_train_attention.fwd_launches`` and ``.bwd_launches``.

``chunk_train_attention_cuda_core`` and ``chunk_train_attention_tensor_core``
launch one route directly, so both can run on the same inputs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import kernels
from .chunk_attention import cuda_core_slices
from .relshift import rel_shift

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x2C1B3C6D, 0x297A2D39   # odd, below 2**30: int64 products never overflow


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash on int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _M32
    x = x ^ (x >> 12)
    x = (x * _MIX2) & _M32
    return x ^ (x >> 15)


def drop_threshold(drop_rate: float) -> int:
    """Keep iff the hash is >= this (the TPU kernel's comparison)."""
    return min(int(drop_rate * 2 ** 32), 2 ** 32 - 1)


def _layout(q, kv, p, chunk, left, right):
    b, tp, heads, d_k = q.shape
    if tp % chunk:
        raise ValueError(f"q has {tp} frames, not a multiple of chunk {chunk}")
    n = tp // chunk
    w = left + chunk + right
    if kv.shape != (b, left + tp + right, heads, 2 * d_k):
        raise ValueError(f"kv shape {tuple(kv.shape)} != {(b, left + tp + right, heads, 2 * d_k)}")
    if p.shape != (2 * chunk - 1 + left + right, heads, d_k):
        raise ValueError(f"p shape {tuple(p.shape)} != {(2 * chunk - 1 + left + right, heads, d_k)}")
    return b, n, heads, d_k, w


def _valid(lens, n, c, left, w) -> torch.Tensor:
    """[B, n, 1, c, W] validity of (query row, window position)."""
    dev = lens.device
    ci = torch.arange(n, device=dev)[:, None, None]
    r = torch.arange(c, device=dev)[None, :, None]
    j = torch.arange(w, device=dev)[None, None, :]
    f = ci * c - left + j
    ln = lens.long()[:, None, None, None]
    ok = (f >= 0) & (f < ln) & (ci * c + r < ln)
    return ok[:, :, None]


def window_keep_mask(seed, lens, n, heads, c, w, drop_rate, head_offset: int = 0,
                     heads_total: int = 0) -> torch.Tensor:
    """[B, n, H, c, W] dropout keep mask: keep iff the hash of (seed,
    utterance b, head head_offset + h of heads_total (0 = H), query frame
    ci*c + r, key stream row ci*c + j) is >= ``drop_threshold`` (the kernels
    compute the same hash)."""
    dev = lens.device
    bi = torch.arange(lens.shape[0], device=dev).view(-1, 1, 1, 1, 1)
    ci = torch.arange(n, device=dev).view(1, -1, 1, 1, 1)
    hi = torch.arange(heads, device=dev).view(1, 1, -1, 1, 1)
    r = torch.arange(c, device=dev).view(1, 1, 1, -1, 1)
    j = torch.arange(w, device=dev).view(1, 1, 1, 1, -1)
    s = _mix(_mix((bi * (heads_total or heads) + head_offset + hi) & _M32) ^ (seed & _M32))
    s = _mix(s ^ (ci * c + r))
    return _mix(s ^ (ci * c + j)) >= drop_threshold(drop_rate)


def _scores(q, kv, p, u, v, chunk, left, right, dtype=torch.float32):
    """Windows and scores in ``dtype`` (f32): (qu, qv, k, vals, s [B, n, H, c, W])."""
    b, n, heads, d_k, w = _layout(q, kv, p, chunk, left, right)
    scale = 1.0 / math.sqrt(d_k)
    win = kv.to(dtype).unfold(1, w, chunk)                # [B, n, H, 2dk, W]
    k, vals = win[:, :, :, :d_k], win[:, :, :, d_k:]
    qc = q.to(dtype).reshape(b, n, chunk, heads, d_k)
    qu = (qc + u.to(dtype)) * scale
    qv = (qc + v.to(dtype)) * scale
    ac = torch.einsum("bnchd,bnhdw->bnhcw", qu, k)
    bd = torch.einsum("bnchd,phd->bnhcp", qv, p.to(dtype))
    return qu, qv, k, vals, ac + rel_shift(bd, left, right)


def forward_plain(q, kv, p, u, v, lens, seed: int, chunk: int, left: int, right: int,
                  drop_rate: float, head_offset: int = 0, heads_total: int = 0,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, differentiable by autograd:
    (ctx [B, n*c, H, dk] in q's dtype, m and den [B, H, n*c] in ``dtype``,
    the dtype it computes in: f32, as the kernels; float64 gives the
    yardstick that f32 statistics are held to)."""
    b, n, heads, d_k, w = _layout(q, kv, p, chunk, left, right)
    _, _, _, vals, s = _scores(q, kv, p, u, v, chunk, left, right, dtype)
    valid = _valid(lens, n, chunk, left, w)
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(-1, keepdim=True).clamp_min(-1e29)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True).clamp_min(1e-30)
    attn = e / den
    if drop_rate > 0.0:
        keep = window_keep_mask(seed, lens, n, heads, chunk, w, drop_rate, head_offset,
                                heads_total)
        attn = attn * keep / (1.0 - drop_rate)
    ctx = torch.einsum("bnhcw,bnhdw->bnchd", attn, vals)
    stats = lambda x: x[..., 0].permute(0, 2, 1, 3).reshape(b, heads, n * chunk)  # noqa: E731
    return ctx.reshape(b, n * chunk, heads, d_k).to(q.dtype), stats(m), stats(den)


def backward_plain(q, kv, p, u, v, lens, m, den, dctx, seed: int, chunk: int, left: int,
                   right: int, drop_rate: float, head_offset: int = 0, heads_total: int = 0):
    """Plain PyTorch version of the backward kernel: (dq, dkv, dp, du, dv).

    Recomputes the weights from (m, den); dS = A * (dA - rowsum(dA * A));
    dq from the content and the un-shifted position branch; the per-window
    dK | dV overlap-added onto the stream, whose L and R pad rows get 0.
    """
    b, n, heads, d_k, w = _layout(q, kv, p, chunk, left, right)
    c = chunk
    scale = 1.0 / math.sqrt(d_k)
    qu, qv, k, vals, s = _scores(q, kv, p, u, v, chunk, left, right)
    valid = _valid(lens, n, c, left, w)
    stat = lambda x: x.reshape(b, heads, n, c).permute(0, 2, 1, 3)[..., None]  # noqa: E731
    attn = torch.exp(s.masked_fill(~valid, -1e30) - stat(m)) / stat(den)
    g = dctx.float().reshape(b, n, c, heads, d_k)
    da = torch.einsum("bnchd,bnhdw->bnhcw", g, vals)
    attn_drop = attn
    if drop_rate > 0.0:
        keep = window_keep_mask(seed, lens, n, heads, c, w, drop_rate, head_offset,
                                heads_total) / (1.0 - drop_rate)
        attn_drop = attn * keep
        da = da * keep
    dvals = torch.einsum("bnhcw,bnchd->bnhwd", attn_drop, g)
    ds = attn * (da - (da * attn).sum(-1, keepdim=True))          # [B, n, H, c, W]
    dqu = torch.einsum("bnhcw,bnhdw->bnchd", ds, k)
    dkeys = torch.einsum("bnhcw,bnchd->bnhwd", ds, qu)
    # un-shift: window position j of row r is positional row c - 1 - r + j
    idx = (c - 1 - torch.arange(c, device=q.device)[:, None]
           + torch.arange(w, device=q.device)[None, :])
    dbd = ds.new_zeros(b, n, heads, c, p.shape[0])
    dbd.scatter_(-1, idx.expand(b, n, heads, c, w), ds)
    dqv = torch.einsum("bnhcp,phd->bnchd", dbd, p.float())
    dp = torch.einsum("bnhcp,bnchd->phd", dbd, qv)
    dq = ((dqu + dqv) * scale).reshape(b, n * c, heads, d_k)
    du = dqu.sum((0, 1, 2)) * scale
    dv = dqv.sum((0, 1, 2)) * scale
    dwin = torch.cat([dkeys, dvals], -1)                           # [B, n, H, W, 2dk]
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        dkv[:, i * c:i * c + w] += dwin[:, i].transpose(1, 2)
    dkv[:, :left] = 0.0
    dkv[:, left + n * c:] = 0.0
    return (dq.to(q.dtype), dkv.to(kv.dtype), dp.to(p.dtype), du.to(u.dtype), dv.to(v.dtype))


def _check(q, kv, p, u, v, lens, chunk, left, right):
    b, n, heads, d_k, _ = _layout(q, kv, p, chunk, left, right)
    if q.device.type != "cuda":
        raise ValueError(f"the training attention kernels run on cuda, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"chunk_train_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("kv", kv), ("p", p), ("u", u), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
    if lens.dtype != torch.int32 or lens.shape != (b,) or not lens.is_contiguous() \
            or lens.device != q.device:
        raise TypeError(f"lens must be a contiguous int32 [B] tensor on {q.device}")
    if u.shape != (heads, d_k) or v.shape != (heads, d_k) or not (
            u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u and v must be contiguous [H, dk]")
    if q.stride(-1) != 1 or kv.stride(-1) != 1 or p.stride(-1) != 1:
        raise ValueError("q, kv and p need a contiguous last axis")
    return b, n, heads, d_k


def route(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, chunk: int) -> str:
    """Which kernels a CUDA call launches, from dtype, shapes and strides
    alone: "tensor_core" (``csrc/chunk_attention_train_tc.cu``, f32 through
    ``csrc/chunk_attention_train_tc_f32.cu``) for f32 or bf16 with head_dim
    64 or 128, any chunk > 0 and every row of q, kv and p 16-byte aligned
    (the kernels copy 16 bytes a thread); "cuda_core"
    (``csrc/chunk_attention_train.cu``) otherwise."""
    d_k = q.shape[-1]
    if q.dtype not in _DTYPES or d_k not in (64, 128) or chunk <= 0:
        return "cuda_core"
    per16 = 16 // q.element_size()
    for t in (q, kv, p):
        if t.data_ptr() % 16 != 0 or any(s % per16 != 0 for s in t.stride()[:-1]):
            return "cuda_core"
    return "tensor_core"


_PATHS = ("cuda_core", "tensor_core")
#: bytes of f32 dP partial slabs the tensor-core backward may allocate: one
#: [P, H, dk] slab per group of utterances (12.5 MB at the flagship shape)
DP_PART_BUDGET = 16 << 20


def _check_path(path, q, kv, p, chunk, d_k):
    if path not in _PATHS:
        raise ValueError(f"path must be one of {_PATHS}, got {path!r}")
    if path == "tensor_core" and route(q, kv, p, chunk) != "tensor_core":
        raise ValueError("the tensor-core kernels take f32 or bf16, head_dim 64 or 128, a chunk "
                         "of at least 1 and 16-byte-aligned rows")


def _strides(t):
    return [t.stride(i) for i in range(t.dim() - 1)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, starting on a 16-byte boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dp_slabs(heads: int, p_len: int, d_k: int) -> int:
    """f32 dP slabs [H, P, dk] that fit DP_PART_BUDGET (at least one)."""
    return max(1, DP_PART_BUDGET // (heads * p_len * d_k * 4))


def dp_group(b: int, heads: int, p_len: int, d_k: int) -> int:
    """Utterances per block of the tensor-core dq kernel: the fewest that keep
    the f32 dP slabs ([ceil(B / group), H, P, dk]) within DP_PART_BUDGET."""
    return -(-b // min(b, _dp_slabs(heads, p_len, d_k)))


def dp_splits(b: int, n: int, heads: int, p_len: int, d_k: int) -> int:
    """Chunk ranges an utterance's dq work is cut into when each utterance
    has a block of its own (``dp_group`` 1) and the budget holds more slabs
    than utterances: up to n ranges of consecutive chunks, each a block with
    its own dP slab, so that a small batch fills more of the card (the dq
    kernel runs one block an SM and is latency-bound). 1 otherwise."""
    if dp_group(b, heads, p_len, d_k) > 1:
        return 1
    return max(1, min(n, _dp_slabs(heads, p_len, d_k) // b))


def partial_shapes(path, b, n, heads, chunk, p_len, d_k, heads_total: int = 0):
    """(shape, zeroed) of each f32 partial buffer a backward launch of
    ``path`` allocates, in the order its entry takes them; ``zeroed`` marks
    the buffers the kernels add into. Tensor cores (f32 and bf16 alike): per
    dq cell (a group of ``dp_group`` utterances, or one utterance's range of
    chunks, ``dp_splits`` a group; h) a dP slab [P, dk] and the band's
    column sums [P] (the v terms of dP and dv), both added into, and per
    dK/dV block (64 key frames of an utterance, ceil(n*c / 64) of them, the
    last partial where 64 does not divide n*c; h) a du partial [dk]; the
    groups are sized by the global
    head count ``heads_total`` (0 = heads), so a tensor-parallel rank sums
    dP over the full call's groups, in its order. CUDA cores: per (b, ci,
    slice of the chunk's rows, h) a dP slab [P, dk] and du | dv [2, dk]."""
    if path == "tensor_core":
        ht = heads_total or heads
        cells = -(-b // dp_group(b, ht, p_len, d_k)) * dp_splits(b, n, ht, p_len, d_k)
        return [((cells, heads, p_len, d_k), True), ((cells, heads, p_len), True),
                ((b * -(-n * chunk // 64), heads, d_k), False)]
    cells = b * n * cuda_core_slices(chunk, d_k)
    return [((cells * heads, p_len, d_k), False), ((cells * heads, 2, d_k), False)]


def forward_kernel(q, kv, p, u, v, lens, seed, chunk, left, right, drop_rate, *, path: str,
                   head_offset: int = 0, heads_total: int = 0):
    """Launch the forward kernel of ``path`` ("cuda_core" or "tensor_core"):
    (ctx, m, den) as ``forward_plain``; raises where that route cannot take
    the operands."""
    b, n, heads, d_k = _check(q, kv, p, u, v, lens, chunk, left, right)
    _check_path(path, q, kv, p, chunk, d_k)
    ctx = torch.empty((b, n * chunk, heads, d_k), dtype=q.dtype, device=q.device)
    m = torch.empty((b, heads, n * chunk), dtype=torch.float32, device=q.device)
    den = torch.empty_like(m)
    lib = kernels.library()
    tc = path == "tensor_core"
    entry = lib.cf_chunk_train_attn_tc_fwd if tc else lib.cf_chunk_train_attn_fwd
    with torch.cuda.device(q.device):
        err = entry(
            _DTYPES[q.dtype], q.data_ptr(), kv.data_ptr(), p.data_ptr(), u.data_ptr(),
            v.data_ptr(), lens.data_ptr(), ctx.data_ptr(), m.data_ptr(), den.data_ptr(),
            b, n, heads, chunk, d_k, left, right, seed & 0xFFFFFFFF, drop_threshold(drop_rate),
            float(1.0 / (1.0 - drop_rate)), int(drop_rate > 0.0), head_offset,
            heads_total or heads, *_strides(q), *_strides(kv), *_strides(p),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, f"chunk_train_attention forward ({path})")
    if tc:
        chunk_train_attention.fwd_tc_launches += 1
    else:
        chunk_train_attention.fwd_launches += 1
    return ctx, m, den


def backward_kernel(q, kv, p, u, v, lens, ctx, m, den, dctx, seed, chunk, left, right,
                    drop_rate, *, path: str, head_offset: int = 0, heads_total: int = 0):
    """Launch the backward kernels of ``path``: (dq, dkv, dp, du, dv) as
    ``backward_plain``; raises where that route cannot take the operands.

    Both routes sum dP, du and dv across blocks from the f32 partials of
    ``partial_shapes``, in a fixed order."""
    b, n, heads, d_k = _check(q, kv, p, u, v, lens, chunk, left, right)
    _check_path(path, q, kv, p, chunk, d_k)
    dev = q.device
    tc = path == "tensor_core"
    dctx = _aligned(dctx)
    ctx = _aligned(ctx)
    p_len = p.shape[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dkv = torch.empty(kv.shape, dtype=kv.dtype, device=dev)
    dkv[:, :left].zero_()
    dkv[:, left + n * chunk:].zero_()
    delta = torch.empty_like(m)
    parts = [(torch.zeros if zeroed else torch.empty)(shape, dtype=torch.float32, device=dev)
             for shape, zeroed in partial_shapes(path, b, n, heads, chunk, p_len, d_k,
                                                 heads_total)]
    group = dp_group(b, heads_total or heads, p_len, d_k)
    splits = dp_splits(b, n, heads_total or heads, p_len, d_k)
    dp = torch.empty((p_len, heads, d_k), dtype=p.dtype, device=dev)
    du = torch.empty((heads, d_k), dtype=u.dtype, device=dev)
    dv = torch.empty((heads, d_k), dtype=v.dtype, device=dev)
    lib = kernels.library()
    entry = lib.cf_chunk_train_attn_tc_bwd if tc else lib.cf_chunk_train_attn_bwd
    shape = (b, n, heads, chunk, d_k, left, right) + ((group, splits) if tc else ())
    with torch.cuda.device(dev):
        err = entry(
            _DTYPES[q.dtype], q.data_ptr(), kv.data_ptr(), p.data_ptr(), u.data_ptr(),
            v.data_ptr(), lens.data_ptr(), ctx.data_ptr(), m.data_ptr(), den.data_ptr(),
            dctx.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
            *(t.data_ptr() for t in parts), dp.data_ptr(), du.data_ptr(),
            dv.data_ptr(), *shape, seed & 0xFFFFFFFF,
            drop_threshold(drop_rate), float(1.0 / (1.0 - drop_rate)), int(drop_rate > 0.0),
            head_offset, heads_total or heads,
            *_strides(q), *_strides(kv), *_strides(p), *_strides(dkv),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, f"chunk_train_attention backward ({path})")
    if tc:
        chunk_train_attention.bwd_tc_launches += 1
    else:
        chunk_train_attention.bwd_launches += 1
    return dq, dkv, dp, du, dv


def _path(path: str, q, kv, p, chunk: int) -> str:
    """"plain" on the CPU for the routed entry ("auto"), else the route to launch."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_train_attention runs on cpu or cuda, not {q.device}")
    if path == "auto":
        return "plain" if q.device.type == "cpu" else route(q, kv, p, chunk)
    return path


@torch.library.custom_op("chunkformer_tpu_torch::chunk_train_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor, lens: torch.Tensor, seed: int, chunk: int, left: int,
            right: int, drop_rate: float, path: str, head_offset: int,
            heads_total: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    how = _path(path, q, kv, p, chunk)
    if how == "plain":
        return forward_plain(q, kv, p, u, v, lens, seed, chunk, left, right, drop_rate,
                             head_offset, heads_total)
    return forward_kernel(q, kv, p, u, v, lens, seed, chunk, left, right, drop_rate, path=how,
                          head_offset=head_offset, heads_total=heads_total)


@torch.library.custom_op("chunkformer_tpu_torch::chunk_train_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor, lens: torch.Tensor, ctx: torch.Tensor, m: torch.Tensor,
            den: torch.Tensor, dctx: torch.Tensor, seed: int, chunk: int, left: int,
            right: int, drop_rate: float, path: str, head_offset: int,
            heads_total: int) -> Tuple[
                torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    how = _path(path, q, kv, p, chunk)
    if how == "plain":
        return backward_plain(q, kv, p, u, v, lens, m, den, dctx, seed, chunk, left, right,
                              drop_rate, head_offset, heads_total)
    return backward_kernel(q, kv, p, u, v, lens, ctx, m, den, dctx, seed, chunk, left, right,
                           drop_rate, path=how, head_offset=head_offset,
                           heads_total=heads_total)


def _setup(ctx, inputs, output):
    q, kv, p, u, v, lens, *statics = inputs
    ctx.save_for_backward(q, kv, p, u, v, lens, *output)
    ctx.statics = tuple(statics)


def _backward(ctx, dctx, _dm, _dden):
    q, kv, p, u, v, lens, out, m, den = ctx.saved_tensors
    dq, dkv, dp, du, dv = _bwd_op(q, kv, p, u, v, lens, out, m, den, dctx, *ctx.statics)
    return (dq, dkv, dp, du, dv) + (None,) * (1 + len(ctx.statics))


_fwd_op.register_autograd(_backward, setup_context=_setup)

#: the forward operator, for selective-checkpoint policies (nn/encoder.py)
FORWARD_OP = torch.ops.chunkformer_tpu_torch.chunk_train_attention_fwd.default


def chunk_train_attention(q, kv, p, u, v, lens, seed: int = 0, *, chunk: int, left: int,
                          right: int, drop_rate: float = 0.0, head_offset: int = 0,
                          heads_total: int = 0) -> torch.Tensor:
    """Differentiable limited-context training attention: ctx [B, n*c, H, dk].

    On a CPU tensor the forward and backward are the plain versions; on a
    CUDA tensor they launch the kernels that ``route`` names, or raise.
    ``seed`` is ignored when ``drop_rate`` is 0. ``head_offset`` and
    ``heads_total`` (0 = q's heads) place q's heads among a tensor-parallel
    run's in the dropout hash.
    """
    return _fwd_op(q, kv, p, u, v, lens, int(seed), chunk, left, right, float(drop_rate),
                   "auto", int(head_offset), int(heads_total))[0]


def chunk_train_attention_cuda_core(q, kv, p, u, v, lens, seed: int = 0, *, chunk: int,
                                    left: int, right: int, drop_rate: float = 0.0,
                                    head_offset: int = 0,
                                    heads_total: int = 0) -> torch.Tensor:
    """``chunk_train_attention`` through the CUDA-core kernels
    (``csrc/chunk_attention_train.cu``) on CUDA tensors, whatever ``route``
    says; raises on others."""
    return _fwd_op(q, kv, p, u, v, lens, int(seed), chunk, left, right, float(drop_rate),
                   "cuda_core", int(head_offset), int(heads_total))[0]


def chunk_train_attention_tensor_core(q, kv, p, u, v, lens, seed: int = 0, *, chunk: int,
                                      left: int, right: int, drop_rate: float = 0.0,
                                      head_offset: int = 0,
                                      heads_total: int = 0) -> torch.Tensor:
    """``chunk_train_attention`` through the tensor-core kernels
    (``csrc/chunk_attention_train_tc.cu``, f32 through
    ``csrc/chunk_attention_train_tc_f32.cu``) on CUDA tensors that ``route``
    sends to them; raises on others."""
    return _fwd_op(q, kv, p, u, v, lens, int(seed), chunk, left, right, float(drop_rate),
                   "tensor_core", int(head_offset), int(heads_total))[0]


chunk_train_attention.fwd_launches = 0     # CUDA-core forward launches since the last reset
chunk_train_attention.bwd_launches = 0     # CUDA-core backward launches (dq, dkv, reduction)
chunk_train_attention.fwd_tc_launches = 0  # tensor-core forward launches, f32 and bf16
chunk_train_attention.bwd_tc_launches = 0  # tensor-core backward launches (dq, dkv, sums)
