"""The decode attention's tensor-core tile walk (``csrc/chunk_attention_tc.cu``,
``csrc/chunk_attention_tc_f32.cu``) emulated in torch on the CPU, at chunk
sizes that 64 does not divide, against the port's plain version and the JAX
package's union kernel (Pallas, interpret mode).

The emulation follows a block of the kernels: one (chunk row n, head, tile of
64 query rows), ceil(c / 64) tiles a chunk, the last one partial with its
rows past the chunk zero-filled; the valid key interval [lo, hi) walked in
tiles of 64 keys (K and V rows past the window zero-filled); 64-row
positional blocks from pb0 = lo + c - 64 - r0, rows outside [0, 2c - 1 + L +
R) zero-filled, each block's product Q P^T + v.p staged once and read by the
key tiles t - 1 and t through the skew S_bd[r, j] = BD'[r, 63 - r + j]; the
split bias form q.k + u.k; the online softmax in the log2 domain; only rows
inside the chunk stored. Products in f32 (the kernels' f32 arithmetic; the
3xTF32 split's own error is held in tests/test_torch_tf32_split.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.ops.pallas.chunk_attention import chunk_attention_pallas_union_hmajor
from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain, route

TILE = 64


def _rows(mat, first, end):
    """Rows [first, first + 64) of mat [rows, H, d] as [H, 64, d], rows
    outside [0, end) zero (the kernels' ``load_tile``)."""
    idx = torch.arange(first, first + TILE)
    ok = (idx >= 0) & (idx < end)
    out = torch.zeros(mat.shape[1], TILE, mat.shape[2], dtype=mat.dtype)
    out[:, ok] = mat[idx[ok]].transpose(0, 1)
    return out


def tile_walk(q, kv, p, u, v, chunk_idx, offsets, max_lens, *, chunk, left, right):
    """The tensor-core kernels' blocks in f32: q [N, c, H, dk], kv [L + N c + R,
    H, 2 dk], p [2c - 1 + L + R, H, dk], u and v [H, dk] -> [N, c, H, dk].
    Asserts on the way that no query row inside the chunk reads a
    zero-filled positional row at a valid key."""
    n_rows, c, heads, d_k = q.shape
    w = left + c + right
    p_rows = 2 * c - 1 + left + right
    scale_log2 = 1.4426950408889634 / math.sqrt(d_k)
    out = torch.full((n_rows, c, heads, d_k), float("nan"))
    uf, vf = u.float(), v.float()
    for n in range(n_rows):
        ci, off, ml = int(chunk_idx[n]), int(offsets[n]), int(max_lens[n])
        lo, hi = max(0, left - ci * c - off), min(w, ml - ci * c + left)
        stream = kv[n * c:].float()
        for r0 in range(0, c, TILE):
            rows = min(TILE, c - r0)
            if hi <= lo:
                out[n, r0:r0 + rows] = 0.0
                continue
            qt = _rows(q[n].float(), r0, c)               # [H, 64, dk], zeros past the chunk
            qt[:, rows:] = 0.0
            pb0 = lo + c - TILE - r0

            def staged(b):
                pt = _rows(p.float(), pb0 + TILE * b, p_rows)          # [H, 64, dk]
                return qt @ pt.transpose(1, 2) + (pt @ vf[:, :, None])[:, None, :, 0]

            stg = [staged(0)]
            m_run = torch.full((heads, TILE), -math.inf)
            l_run = torch.zeros(heads, TILE)
            o = torch.zeros(heads, TILE, d_k)
            for t in range(-(-(hi - lo) // TILE)):
                j0 = lo + TILE * t
                kt = _rows(stream[:, :, :d_k], j0, w)                   # zero past the window
                vt = _rows(stream[:, :, d_k:], j0, w)
                stg.append(staged(t + 1))
                s = qt @ kt.transpose(1, 2) + (kt @ uf[:, :, None])[:, None, :, 0]
                rr = torch.arange(TILE)[:, None]
                jj = torch.arange(TILE)[None, :]
                idx = TILE - 1 - rr + jj                                # 0 .. 126
                both = torch.cat([stg[t], stg[t + 1]], dim=2)           # [H, 64, 128]
                bd = torch.gather(both, 2, idx.expand(heads, TILE, TILE))
                pos = pb0 + TILE * t + idx                              # positional row read
                live = (rr < rows) & (j0 + jj < hi)
                assert bool(((pos >= 0) & (pos < p_rows))[live].all())
                assert bool((pos == c - 1 - (r0 + rr) + (j0 + jj))[live].all())
                score = (s + bd) * scale_log2
                score = score.masked_fill(~(j0 + jj < hi)[None], -math.inf)
                m_new = torch.maximum(m_run, score.amax(dim=2))
                alpha = torch.exp2(m_run - m_new)
                prob = torch.exp2(score - m_new[:, :, None])
                l_run = l_run * alpha + prob.sum(dim=2)
                o = o * alpha[:, :, None] + prob @ vt
                m_run = m_new
            inv = torch.where(l_run > 0, 1.0 / l_run, torch.zeros_like(l_run))
            res = o * inv[:, :, None]                                   # [H, 64, dk]
            out[n, r0:r0 + rows] = res[:, :rows].transpose(0, 1)       # rows inside the chunk
    assert not bool(out.isnan().any())
    return out.to(q.dtype)


def _inputs(seed, n, c, heads, d_k, left, right):
    """Head-major numpy operands: two utterances, the first at a decode
    offset with a partial tail, then a padding row (no valid key)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, heads, c, d_k)).astype(np.float32)
    kv = rng.normal(size=(heads, left + n * c + right, 2 * d_k)).astype(np.float32)
    p = rng.normal(size=(heads, 2 * c - 1 + left + right, d_k)).astype(np.float32)
    u = rng.normal(size=(heads, d_k)).astype(np.float32)
    v = rng.normal(size=(heads, d_k)).astype(np.float32)
    n1 = n - 3
    ci = np.array(list(range(n1)) + [0, 1, 0], np.int32)
    off = np.array([3] * n1 + [0, 0, 0], np.int32)
    ml = np.array([n1 * c - 5] * n1 + [2 * c - 7] * 2 + [0], np.int32)
    return q, kv, p, u, v, ci, off, ml


@pytest.mark.parametrize("c,left,right", [(96, 32, 16), (48, 64, 32), (72, 16, 0),
                                          (16, 64, 64)])
def test_partial_tile_walk_matches_plain_and_union_kernel(c, left, right):
    """c = 96 (a full tile and a partial one of 32 rows), 48 and 16 (one
    partial tile at r0 = 0), 72 (a partial tile of 8 rows), with windows that
    64 does not divide; f32 atol 1e-5, the JAX kernels' own bar. The shapes
    take the tensor-core route."""
    n, heads, d_k = 8, 2, 64
    arrays = _inputs(c + left, n, c, heads, d_k, left, right)
    q, kv, p, u, v, ci, off, ml = (torch.from_numpy(a) for a in arrays)
    args = (q.transpose(1, 2), kv.transpose(0, 1), p.transpose(0, 1), u, v, ci, off, ml)
    kw = dict(chunk=c, left=left, right=right)
    assert route(*(a.contiguous() for a in args[:3])) == "tensor_core"
    got = tile_walk(*args, **kw)
    plain = chunk_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    union = chunk_attention_pallas_union_hmajor(*map(jnp.asarray, arrays), g=8, interpret=True,
                                                **kw)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(union), atol=1e-5, rtol=0)
    assert not bool(got[-1].any())                                      # the padding row
