"""The training attention's tensor-core tile walk (``csrc/chunk_attention_train_tc.cu``,
``csrc/chunk_attention_train_tc_f32.cu``), forward and backward, emulated in
torch on the CPU at chunk sizes that 64 does not divide, against the port's
plain versions and the JAX package's Pallas kernels (``_attn_fwd_call`` and
``_attn_core_bwd`` in interpret mode).

The emulation follows the kernels' blocks, in f32 (the kernels' f32
arithmetic; the 3xTF32 split's own error is held in
tests/test_torch_tf32_split.py):
- forward, a block per (utterance, chunk, head, 64 query rows), ceil(c / 64)
  blocks a chunk: the last holds c - r0 rows, its rows past the chunk load as
  zeros, take no valid key and are not stored; the key window [lo, hi) in
  tiles of 64 keys; 64-row positional blocks from pb0 = lo + c - 64 - r0
  (rows outside [0, P) zero-filled), each staged once and read through the
  skew S_bd[r, j] = BD'[r, 63 - r + j]; the online softmax in the log2
  domain; dropout by the hash of absolute positions;
- the dq kernel, a block per cell (``dp_group`` utterances, or one
  utterance's range of chunks, ``dp_splits`` of them; here three cells an
  utterance), walking its chunks and 64-row query blocks:
  delta = rowsum(A dA) in a pre-pass over the key tiles (the bf16 kernel),
  or rowsum(dctx ctx) (the f32 kernel, whose dK/dV kernel takes rowsum(A
  dA) of the same pass), dS = A (dA - delta), dq += dS K, dS written skewed
  into a [64][128] band over the tile's two positional blocks, the band's
  column sums and band^T Q added into the cell's slabs at the positional
  rows inside [0, P), dq += band [P_t; P_t+1];
- the dK/dV kernel, a block per (utterance, 64 key frames), ceil(n c / 64)
  of them, the last holding n c - f0 frames: every query chunk and 64-row
  block whose window meets those keys (``key_block_chunks``,
  ``next_block``), rows past the chunk zero, dK += dS^T Q, dV += A_drop^T
  dctx, the dS column sums for dK's u term and a du partial, rows past n c
  not stored;
- the partial sums: dp, du, dv, the cells' slabs summed in order.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.ops.pallas.chunk_attention_train import (_attn_core_bwd,
                                                             _attn_fwd_call, pick_group)
from chunkformer_tpu_torch.ops import chunk_attention_train as cat

TILE = 64
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation's many small products on one thread: faster than the
    default pool, and six test workers then do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(mat, first, end):
    """Rows [first, first + 64) of mat [rows, H, d] as [H, 64, d], rows
    outside [0, end) zero (the kernels' ``load_tile``)."""
    idx = torch.arange(first, first + TILE)
    ok = (idx >= 0) & (idx < end)
    out = torch.zeros(mat.shape[1], TILE, mat.shape[2], dtype=torch.float32)
    out[:, ok] = mat[idx[ok]].float().transpose(0, 1)
    return out


def _keep(seed, b, heads, fq, fk, drop):
    """[H, 64, 64] keep mask of query frames fq [64] and key stream rows fk
    [64] (``drop_row`` and ``mix32`` in the kernels, ``window_keep_mask``)."""
    h = torch.arange(heads).view(-1, 1, 1)
    s = cat._mix(cat._mix((b * heads + h) & cat._M32) ^ (seed & cat._M32))
    s = cat._mix(s ^ fq.view(1, -1, 1).long())
    return cat._mix(s ^ fk.view(1, 1, -1).long()) >= cat.drop_threshold(drop)


def _staged(qt, p, first, p_rows, v):
    """The staged product of one positional block: Q P_b^T + v.p [H, 64, 64]."""
    pt = _rows(p, first, p_rows)
    return qt @ pt.transpose(1, 2) + (pt @ v[:, :, None])[:, None, :, 0], pt


def _skew(lo_slot, hi_slot):
    """BD'[r, 63 - r + j] over two staged blocks: [H, 64 rows, 64 keys]."""
    idx = (TILE - 1 - torch.arange(TILE)[:, None] + torch.arange(TILE)[None, :])
    both = torch.cat([lo_slot, hi_slot], dim=2)
    return torch.gather(both, 2, idx.expand(both.shape[0], TILE, TILE))


def key_block_chunks(f0, c, n, left, right):
    num = f0 - c - right
    ci_lo = max(0, (num // c if num >= 0 else -((-num + c - 1) // c)) + 1)
    return ci_lo, min(n - 1, (f0 + 63 + left) // c)


def fwd_walk(q, kv, p, u, v, lens, seed, c, left, right, drop):
    """The forward kernels' blocks: (ctx [B, n c, H, dk], m, den [B, H, n c])."""
    b_n, tp, heads, d_k = q.shape
    n, w, p_rows = tp // c, left + c + right, p.shape[0]
    scale_log2 = LOG2E / math.sqrt(d_k)
    uf, vf = u.float(), v.float()
    ctx = torch.full((b_n, tp, heads, d_k), float("nan"))
    m_out = torch.full((b_n, heads, tp), float("nan"))
    den_out = torch.full((b_n, heads, tp), float("nan"))
    rr, jj = torch.arange(TILE)[:, None], torch.arange(TILE)[None, :]
    for b in range(b_n):
        ln = int(lens[b])
        stream = kv[b].float()
        for ci in range(n):
            lo, hi = max(0, left - ci * c), min(w, ln - ci * c + left)
            for r0 in range(0, c, TILE):
                crows = min(TILE, c - r0)
                rows = min(crows, ln - ci * c - r0)
                t0 = ci * c + r0
                if hi <= lo or rows <= 0:
                    ctx[b, t0:t0 + crows] = 0.0
                    m_out[b, :, t0:t0 + crows] = -1e29
                    den_out[b, :, t0:t0 + crows] = 1e-30
                    continue
                qt = _rows(q[b], t0, t0 + crows)          # zero past the chunk
                pb0 = lo + c - TILE - r0
                stg = [_staged(qt, p, pb0, p_rows, vf)[0]]
                m_run = torch.full((heads, TILE), -math.inf)
                l_run = torch.zeros(heads, TILE)
                o = torch.zeros(heads, TILE, d_k)
                for t in range(-(-(hi - lo) // TILE)):
                    j0 = lo + TILE * t
                    kt = _rows(stream[ci * c:, :, :d_k], j0, w)
                    vt = _rows(stream[ci * c:, :, d_k:], j0, w)
                    stg.append(_staged(qt, p, pb0 + TILE * (t + 1), p_rows, vf)[0])
                    s = qt @ kt.transpose(1, 2) + (kt @ uf[:, :, None])[:, None, :, 0]
                    score = (s + _skew(stg[t], stg[t + 1])) * scale_log2
                    score = score.masked_fill(~((j0 + jj < hi) & (rr < rows))[None], -math.inf)
                    m_new = torch.maximum(m_run, score.amax(dim=2))
                    m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
                    alpha = torch.exp2(m_run - m_use)
                    prob = torch.exp2(score - m_use[:, :, None])
                    l_run = l_run * alpha + prob.sum(dim=2)
                    if drop:
                        prob = prob * _keep(seed, b, heads, t0 + torch.arange(TILE),
                                            ci * c + j0 + torch.arange(TILE), drop) / (1 - drop)
                    o = o * alpha[:, :, None] + prob @ vt
                    m_run = m_new
                inv = torch.where(l_run > 0, 1.0 / l_run, torch.zeros_like(l_run))
                ctx[b, t0:t0 + crows] = (o * inv[:, :, None])[:, :crows].transpose(0, 1)
                m = torch.where(l_run > 0, torch.clamp_min(m_run * LN2, -1e29),
                                torch.full_like(m_run, -1e29))
                m_out[b, :, t0:t0 + crows] = m[:, :crows]
                den_out[b, :, t0:t0 + crows] = torch.clamp_min(l_run, 1e-30)[:, :crows]
    for x in (ctx, m_out, den_out):
        assert not bool(x.isnan().any())
    return ctx, m_out, den_out


def _weights(qt, kt, vt, gt, stg_lo, stg_hi, u, scale_log2, rm, rinv, ok):
    """A and dA of one (query block, key tile) as the kernels form them."""
    s = qt @ kt.transpose(1, 2) + (kt @ u[:, :, None])[:, None, :, 0]
    sc = (s + _skew(stg_lo, stg_hi)) * scale_log2
    att = torch.where(ok[None], torch.exp2(sc - rm[:, :, None]) * rinv[:, :, None],
                      torch.zeros_like(sc))
    return att, gt @ vt.transpose(1, 2)


def _stats(m, den, delta, b, t0, crows):
    """Row statistics of a block [H, 64]: rows past the chunk get 0 stand-ins."""
    heads = m.shape[1]
    out = [torch.zeros(heads, TILE) for _ in range(3)]
    out[0][:, :crows] = m[b, :, t0:t0 + crows] * LOG2E
    out[1][:, :crows] = 1.0 / den[b, :, t0:t0 + crows]
    if delta is not None:
        out[2][:, :crows] = delta[b, :, t0:t0 + crows]
    return out


def bwd_walk(q, kv, p, u, v, lens, ctx, m, den, dctx, seed, c, left, right, drop,
             delta_from_ctx=False):
    """The backward kernels' blocks: (dq, dkv, dp, du, dv) in f32."""
    b_n, tp, heads, d_k = q.shape
    n, w, p_rows = tp // c, left + c + right, p.shape[0]
    scale = 1.0 / math.sqrt(d_k)
    scale_log2 = LOG2E * scale
    uf, vf = u.float(), v.float()
    rr, jj = torch.arange(TILE)[:, None], torch.arange(TILE)[None, :]
    dq = torch.full((b_n, tp, heads, d_k), float("nan"))
    delta = torch.full((b_n, heads, tp), float("nan"))
    group = cat.dp_group(b_n, heads, p_rows, d_k)
    splits = cat.dp_splits(b_n, n, heads, p_rows, d_k)
    cells = -(-b_n // group) * splits
    slabs = torch.zeros(cells, heads, p_rows, d_k)        # a dP slab and column sums a cell
    cs_slabs = torch.zeros(cells, heads, p_rows)

    # (a) the dq kernel, cell by cell
    for cell, b, ci in ((cell, b, ci) for cell in range(cells)
                        for b in range(cell // splits * group,
                                       min(b_n, (cell // splits + 1) * group))
                        for ci in range(cell % splits * n // splits,
                                        (cell % splits + 1) * n // splits)):
        ln = int(lens[b])
        stream = kv[b].float()
        slab, cs_slab = slabs[cell], cs_slabs[cell]
        lo, hi = max(0, left - ci * c), min(w, ln - ci * c + left)
        for r0 in range(0, c, TILE):
            crows = min(TILE, c - r0)
            rows = min(crows, ln - ci * c - r0)
            t0 = ci * c + r0
            if hi <= lo or rows <= 0:
                delta[b, :, t0:t0 + crows] = 0.0
                dq[b, t0:t0 + crows] = 0.0
                continue
            rm, rinv, _ = _stats(m, den, None, b, t0, crows)
            qt, gt = _rows(q[b], t0, t0 + crows), _rows(dctx[b], t0, t0 + crows)
            pb0 = lo + c - TILE - r0
            n_tiles = -(-(hi - lo) // TILE)
            stg = [_staged(qt, p, pb0 + TILE * t, p_rows, vf) for t in range(n_tiles + 1)]

            def tile(t):
                j0 = lo + TILE * t
                kt = _rows(stream[ci * c:, :, :d_k], j0, w)
                vt = _rows(stream[ci * c:, :, d_k:], j0, w)
                att, da = _weights(qt, kt, vt, gt, stg[t][0], stg[t + 1][0], uf,
                                   scale_log2, rm, rinv, (j0 + jj < hi) & (rr < rows))
                if drop:
                    da = da * _keep(seed, b, heads, t0 + torch.arange(TILE),
                                    ci * c + j0 + torch.arange(TILE), drop) / (1 - drop)
                return kt, att, da

            dsum = sum((lambda a: (a[1] * a[2]).sum(-1))(tile(t)) for t in range(n_tiles))
            delta[b, :, t0:t0 + crows] = dsum[:, :crows]
            if delta_from_ctx:
                rdelta = torch.zeros(heads, TILE)
                rdelta[:, :crows] = (dctx[b, t0:t0 + crows].float()
                                     * ctx[b, t0:t0 + crows].float()).sum(-1).T
            else:
                rdelta = dsum
            dacc = torch.zeros(heads, TILE, d_k)
            for t in range(n_tiles):
                kt, att, da = tile(t)
                ds = att * (da - rdelta[:, :, None])
                dacc += ds @ kt
                band = torch.zeros(heads, TILE, 2 * TILE)
                band.scatter_(2, (TILE - 1 - rr + jj).expand(heads, TILE, TILE), ds)
                prow = pb0 + TILE * t + torch.arange(2 * TILE)
                inside = (prow >= 0) & (prow < p_rows)
                assert not bool(band[:, :, ~inside].any())  # only rows past the chunk
                cs_slab[:, prow[inside]] += band.sum(1)[:, inside]
                pt = torch.cat([stg[t][1], stg[t + 1][1]], dim=1)        # [H, 128, dk]
                dacc += band @ pt
                slab[:, prow[inside]] += (band.transpose(1, 2) @ qt)[:, inside]
            dq[b, t0:t0 + crows] = (dacc * scale)[:, :crows].transpose(0, 1)

    # (b) the dK/dV kernel
    dkv = torch.zeros(kv.shape, dtype=torch.float32)
    du = torch.zeros(heads, d_k)
    n_blocks = -(-tp // TILE)
    for b in range(b_n):
        ln = int(lens[b])
        stream = kv[b].float()
        for f0 in range(0, n_blocks * TILE, TILE):
            krows = min(TILE, tp - f0)
            kt = _rows(stream[:, :, :d_k], left + f0, left + tp)
            vt = _rows(stream[:, :, d_k:], left + f0, left + tp)
            ci_lo, ci_hi = key_block_chunks(f0, c, n, left, right)
            dk, dv_acc = torch.zeros(heads, TILE, d_k), torch.zeros(heads, TILE, d_k)
            cs_tot = torch.zeros(heads, TILE)
            ci, r0 = ci_lo, 0
            while f0 < ln and ci <= ci_hi and ci * c < ln:
                crows = min(TILE, c - r0)
                t0 = ci * c + r0
                j0 = left + f0 - ci * c
                pbase = c - TILE - r0 + j0
                rm, rinv, rdelta = _stats(m, den, delta, b, t0, crows)
                qt, gt = _rows(q[b], t0, t0 + crows), _rows(dctx[b], t0, t0 + crows)
                key_ok = (j0 + jj >= 0) & (j0 + jj < w) & (f0 + jj < ln)
                ok = key_ok & (rr < crows) & (t0 + rr < ln)
                att, da = _weights(qt, kt, vt, gt, _staged(qt, p, pbase, p_rows, vf)[0],
                                   _staged(qt, p, pbase + TILE, p_rows, vf)[0], uf,
                                   scale_log2, rm, rinv, ok)
                adrop = att
                if drop:
                    keep = _keep(seed, b, heads, t0 + torch.arange(TILE),
                                 left + f0 + torch.arange(TILE), drop) / (1 - drop)
                    adrop, da = att * keep, da * keep
                ds = att * (da - rdelta[:, :, None])
                dk += ds.transpose(1, 2) @ qt
                dv_acc += adrop.transpose(1, 2) @ gt
                cs_tot += ds.sum(1)
                r0 += TILE                                 # next_block
                if r0 >= c or ci * c + r0 >= ln:
                    ci, r0 = ci + 1, 0
            du += (cs_tot[:, :, None] * kt).sum(1)
            dk = (dk + cs_tot[:, :, None] * uf[:, None, :]) * scale
            rows = slice(left + f0, left + f0 + krows)
            dkv[b, rows, :, :d_k] = dk[:, :krows].transpose(0, 1)
            dkv[b, rows, :, d_k:] = dv_acc[:, :krows].transpose(0, 1)

    # (c, d) the sums, over the cells in order
    slab, cs_slab = slabs[0].clone(), cs_slabs[0].clone()
    for cell in range(1, cells):
        slab += slabs[cell]
        cs_slab += cs_slabs[cell]
    dp = ((slab + cs_slab[:, :, None] * vf[:, None, :]) * scale).transpose(0, 1)
    dv = (cs_slab[:, :, None] * p.float().transpose(0, 1)).sum(1) * scale
    assert not bool(dq.isnan().any())
    return dq, dkv, dp, du * scale, dv


# (c, L, R, lens): n = 3 chunks; c = 96 (a full block and one of 32 rows; n c =
# 288, four key blocks and one of 32), 72 (64 + 8 rows; 216 = 3 x 64 + 24), 48
# and 16 (one partial block at r0 = 0; 144 and 48 frames), 1 (a block of one
# row; 3 frames, one key block of 3); ragged lens with a length of 1
CASES = [(96, 32, 16, [288, 251, 101, 1]), (72, 64, 0, [216, 150, 73, 1]),
         (48, 64, 32, [144, 100, 49, 1]), (16, 64, 64, [48, 31, 17, 1]),
         (1, 16, 8, [3, 2, 1])]
HEADS, D_K = 2, 64


@functools.lru_cache(maxsize=None)
def _case(c, left, right, lens):
    """Seeded numpy operands in the port's layout (q [B, n c, H, dk], kv [B,
    L + n c + R, H, 2dk] with zero pad rows, p [P, H, dk], u, v [H, dk]) and
    dctx."""
    rng = np.random.default_rng(c + left)
    b, tp = len(lens), 3 * c
    q = rng.normal(size=(b, tp, HEADS, D_K)).astype(np.float32)
    kv = rng.normal(size=(b, left + tp + right, HEADS, 2 * D_K)).astype(np.float32)
    kv[:, :left] = 0
    kv[:, left + tp:] = 0
    p = rng.normal(size=(2 * c - 1 + left + right, HEADS, D_K)).astype(np.float32)
    u, v = (rng.normal(size=(HEADS, D_K)).astype(np.float32) for _ in range(2))
    dctx = rng.normal(size=q.shape).astype(np.float32)
    return q, kv, p, u, v, np.asarray(lens, np.int32), dctx


def _torch(c, left, right, lens):
    q, kv, p, u, v, ln, dctx = _case(c, left, right, tuple(lens))
    return [torch.from_numpy(a) for a in (q, kv, p, u, v, ln)], torch.from_numpy(dctx)


@functools.lru_cache(maxsize=None)
def _pallas(c, left, right, lens):
    """The JAX package's forward and backward kernels (interpret mode, p =
    0) on the same operands, back in the port's layout: (ctx, m, den), (dq,
    dkv, dp, du, dv)."""
    q, kv, p, u, v, ln, dctx = _case(c, left, right, lens)
    b, tp = q.shape[:2]
    n = tp // c
    g = pick_group(n)
    t1 = g * c

    def rm(x):       # [B, n c, H, d] -> [B * n / g, H, g c, d]
        return jnp.asarray(x.reshape(b, n // g, t1, HEADS, -1).transpose(0, 1, 3, 2, 4)
                           .reshape(b * n // g, HEADS, t1, -1))

    def back(x):     # the inverse
        return np.asarray(x).reshape(b, n // g, HEADS, t1, -1).transpose(0, 1, 3, 2, 4) \
            .reshape(b, tp, HEADS, -1)

    statics = (c, left, right, g, 0.0, True)
    ops = (rm(q), jnp.asarray(kv.transpose(0, 2, 1, 3)), jnp.asarray(p.transpose(1, 0, 2)),
           jnp.asarray(u), jnp.asarray(v), jnp.asarray(ln), jnp.zeros((), jnp.uint32))
    ctx, m, den = _attn_fwd_call(statics, *ops)
    grads = _attn_core_bwd(statics, (*ops, m, den), rm(dctx))

    def stat(x):     # [B * n / g, H, 1, g c] -> [B, H, n c]
        return np.asarray(x).reshape(b, n // g, HEADS, t1).transpose(0, 2, 1, 3).reshape(
            b, HEADS, tp)

    fwd = (back(ctx), stat(m), stat(den))
    bwd = (back(grads[0]), np.asarray(grads[1]).transpose(0, 2, 1, 3),
           np.asarray(grads[2]).transpose(1, 0, 2), np.asarray(grads[3]), np.asarray(grads[4]))
    return fwd, bwd


@pytest.mark.parametrize("c,left,right,lens", CASES)
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_partial_block_forward_walk(c, left, right, lens, drop):
    """The forward blocks against the plain version at f32 atol 1e-5 (m and
    den rtol 1e-5), and at p = 0 against the Pallas forward kernel (whose
    TPU dropout stream the port does not share). The shapes take the
    tensor-core route."""
    args, _ = _torch(c, left, right, lens)
    assert cat.route(*args[:3], c) == "tensor_core"
    st = (77, c, left, right, drop)
    got = fwd_walk(*args, *st)
    want = cat.forward_plain(*args, *st)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=0)
    for g, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=0, rtol=1e-5)
    if drop == 0.0:
        ctx, m, den = _pallas(c, left, right, tuple(lens))[0]
        np.testing.assert_allclose(got[0].numpy(), ctx, atol=1e-5, rtol=0)
        ln = np.asarray(lens)
        live = np.arange(3 * c)[None, None, :] < ln[:, None, None]   # rows inside the length
        np.testing.assert_allclose(got[1].numpy()[np.broadcast_to(live, m.shape)],
                                   m[np.broadcast_to(live, m.shape)], atol=0, rtol=1e-5)
        np.testing.assert_allclose(got[2].numpy()[np.broadcast_to(live, den.shape)],
                                   den[np.broadcast_to(live, den.shape)], atol=0, rtol=1e-5)


@pytest.mark.parametrize("c,left,right,lens", CASES)
@pytest.mark.parametrize("drop,delta_from_ctx", [(0.0, False), (0.1, False), (0.1, True)])
def test_partial_block_backward_walk(c, left, right, lens, drop, delta_from_ctx):
    """The dq, dK/dV and sum kernels' blocks (delta from the pre-pass, as
    the bf16 dq kernel takes it, or from rowsum(dctx ctx), as the f32 one
    does) against ``backward_plain`` at f32 atol 1e-4, and at p = 0 against
    the Pallas backward kernel; the pad rows and the rows past each length
    get no gradient."""
    args, dctx = _torch(c, left, right, lens)
    st = (77, c, left, right, drop)
    ctx, m, den = cat.forward_plain(*args, *st)
    got = bwd_walk(*args, ctx, m, den, dctx, *st, delta_from_ctx=delta_from_ctx)
    want = cat.backward_plain(*args, m, den, dctx, *st)
    for name, g, e in zip(("dq", "dkv", "dp", "du", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=1e-4, rtol=0, err_msg=name)
    if drop == 0.0:
        for name, g, e in zip(("dq", "dkv", "dp", "du", "dv"), got,
                              _pallas(c, left, right, tuple(lens))[1]):
            np.testing.assert_allclose(g.numpy(), e, atol=1e-4, rtol=0, err_msg=name)
    dkv = got[1]
    assert not bool(dkv[:, :left].any()) and not bool(dkv[:, left + 3 * c:].any())
    for i, ln in enumerate(lens):
        assert not bool(dkv[i, left + ln:left + 3 * c].any()) and not bool(got[0][i, ln:].any())


@pytest.mark.parametrize("c,n,blocks", [(72, 4, 5), (96, 3, 5), (64, 4, 4), (48, 3, 3),
                                        (16, 3, 1)])
def test_partial_shapes_count_the_key_blocks(c, n, blocks):
    """The tensor-core backward's du partials: one row per dK/dV block,
    ceil(n c / 64) an utterance (c = 72, n = 4: 288 frames, four whole
    blocks and one of 32 frames); the dP slabs and column sums, one a dq
    cell, do not depend on the chunk's split into blocks."""
    b, heads, d_k = 3, 8, 64
    p_len = 2 * c - 1 + 128 + 128
    shapes = cat.partial_shapes("tensor_core", b, n, heads, c, p_len, d_k)
    assert shapes[2] == ((b * blocks, heads, d_k), False)
    assert blocks == -(-n * c // 64)
    cells = -(-b // cat.dp_group(b, heads, p_len, d_k)) * cat.dp_splits(b, n, heads, p_len, d_k)
    assert shapes[:2] == [((cells, heads, p_len, d_k), True), ((cells, heads, p_len), True)]


@pytest.mark.parametrize("b,c,d_k,want", [(32, 64, 64, (2, 1)), (8, 96, 64, (1, 2)),
                                          (8, 72, 64, (1, 2)), (8, 48, 128, (1, 1)),
                                          (8, 16, 64, (1, 3)), (2, 96, 64, (1, 4))])
def test_dq_cells_fill_the_budget(b, c, d_k, want):
    """(utterances a dq cell, chunk ranges an utterance) at H = 8, n = 4, L =
    R = 128: the flagship batch keeps its 16 cells of two utterances; a
    batch of 8 gets up to budget // slab cells (c = 96: 17 slabs of 0.92 MB
    in 16 MB, so two ranges of two chunks an utterance; dk 128 at c = 48:
    11, so one); never more ranges than chunks; the slabs stay within
    ``DP_PART_BUDGET``."""
    p_len = 2 * c - 1 + 256
    got = (cat.dp_group(b, 8, p_len, d_k), cat.dp_splits(b, 4, 8, p_len, d_k))
    assert got == want
    cells = cat.partial_shapes("tensor_core", b, 4, 8, c, p_len, d_k)[0][0][0]
    assert cells == -(-b // got[0]) * got[1]
    assert cells * 8 * p_len * d_k * 4 <= cat.DP_PART_BUDGET
