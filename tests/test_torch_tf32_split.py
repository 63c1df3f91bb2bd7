"""The numerical design of the f32 tensor-core decode attention
(``chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu``), on the CPU.

TF32 keeps 10 explicit mantissa bits. The kernel splits every operand of its
three products (S = Q K^T, BD' = Q P^T, O = P V) as a = hi + lo, hi =
tf32(a) and lo = tf32(a - hi), both rounded to nearest with ties away from
zero (``cvt.rna.tf32.f32``), and sums hi.lo + lo.hi in one f32 accumulator
and hi.hi in another. Here TF32 is emulated by rounding the f32 bit pattern
at bit 13 and clearing the low 13 bits; each pass's products of TF32 values
are exact in f64 and are rounded to f32 as the kernel's accumulator holds
them. The bias terms u.k and v.p, the softmax and 1/sqrt(dk) stay in f32, as
in the kernel.

At the flagship decode shape (N = 209, H = 8, c = 64, dk = 64, L = R = 128,
a middle macro-segment) on seeded random data:
- the 3-pass split stays within 1e-5 of the f64 result and of
  ``chunk_attention_plain`` (the f32 bar of the kernels);
- one TF32 pass does not, which is why the kernel splits.
No JAX; the card's own truncating accumulation is held by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from chunkformer_tpu_torch.ops.chunk import parallel_chunk_att_mask
from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain
from chunkformer_tpu_torch.ops.relshift import rel_shift

N, H, C, DK, L, R = 209, 8, 64, 64, 128, 128
W = L + C + R


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32 value, ties away from zero (the sign
    and magnitude bits of an IEEE float round like an unsigned integer)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b^T over the last axis as the kernel forms it: "f64" exactly,
    "split" as three TF32 passes, "single" as one TF32 pass."""
    if mode == "f64":
        return a.double() @ b.double().transpose(-1, -2)

    def mm(x, y):  # exact products of TF32 values, the sum rounded to f32
        return (x.double() @ y.double().transpose(-1, -2)).float()

    a_hi, b_hi = tf32(a), tf32(b)
    if mode == "single":
        return mm(a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (mm(a_hi, b_lo) + mm(a_lo, b_hi)) + mm(a_hi, b_hi)


def emulated(q, kv, p, u, v, mask, mode: str) -> torch.Tensor:
    """The kernel's algorithm, one head at a time: [N, c, H, dk]."""
    f = torch.float64 if mode == "f64" else torch.float32
    out = []
    for h in range(H):
        win = kv[:, h].unfold(0, W, C)[:N]                    # [N, 2dk, W]
        k, vals = win[:, :DK].transpose(1, 2), win[:, DK:]    # [N, W, dk], [N, dk, W]
        qh, ph = q[:, :, h], p[:, h]
        uk = (k.to(f) @ u[h].to(f))[:, None, :]               # f32 dot products
        vp = (ph.to(f) @ v[h].to(f))[None, None, :]
        ac = product(qh, k, mode).to(f) + uk
        bd = product(qh, ph[None].expand(N, -1, -1), mode).to(f) + vp
        s = (ac + rel_shift(bd, L, R)) / math.sqrt(DK)
        s = s.masked_fill(~mask, -math.inf)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        prob = e / e.sum(-1, keepdim=True)
        out.append(product(prob, vals, mode).to(f))           # [N, c, dk]
    return torch.stack(out, dim=2)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(20261017)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kv = rnd(N, C, H, DK), rnd(L + N * C + R, H, 2 * DK)
    p, u, v = rnd(2 * C - 1 + L + R, H, DK), rnd(H, DK), rnd(H, DK)
    # a middle macro-segment: a decode offset, the last rows' lookahead past max_len
    meta = [torch.arange(N, dtype=torch.int32), torch.full((N,), 1000, dtype=torch.int32),
            torch.full((N,), N * C - 37, dtype=torch.int32)]
    mask = parallel_chunk_att_mask(*(m.long() for m in meta), C, L, R)
    exact = emulated(q, kv, p, u, v, mask, "f64")
    return (q, kv, p, u, v, meta, mask), exact


def test_split_holds_the_f32_bar(case):
    (q, kv, p, u, v, meta, mask), exact = case
    got = emulated(q, kv, p, u, v, mask, "split")
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err_exact = float((got.double() - exact).abs().max())
    plain = chunk_attention_plain(q, kv, p, u, v, *meta, chunk=C, left=L, right=R)
    err_plain = float((got - plain).abs().max())
    assert err_exact <= 1e-5, err_exact
    assert err_plain <= 1e-5, err_plain


def test_single_tf32_pass_misses_the_f32_bar(case):
    (q, kv, p, u, v, meta, mask), exact = case
    got = emulated(q, kv, p, u, v, mask, "single")
    err = float((got.double() - exact).abs().max())
    assert err > 1e-5, err
    assert err < 1e-1, err  # still the same function: the error is rounding, not a fault


def test_tf32_rounding():
    """Ties away from zero at bit 13; exact TF32 values stay; lo is small."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -9, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi = tf32(a)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((a - hi).abs() / a.abs()).max()) <= 2.0 ** -11


# ---------------------------------------------------------------- training backward
#
# The f32 tensor-core backward of the training attention
# (``csrc/chunk_attention_train_tc_f32.cu``) runs eight split products per
# key tile: the recomputed S = Q K^T and BD = Q P^T, dA = dctx V^T, dq = dS K
# and band P, dK = dS^T Q, dV = A^T dctx and dP = band^T Q (band: dS
# un-shifted onto the positional rows). The bias terms u.k and v.p, the
# softmax statistics, delta = rowsum(dctx * ctx), dS = A (dA - delta), the
# column sums of dS (the u term of dK and du, the v term of dP and dv) and
# 1/sqrt(dk) stay in f32, as in the kernels. Here each product goes through
# ``product`` (three TF32 passes, or one), at the flagship train shape
# (199 subsampled frames, H = 8, c = 64, dk = 64, L = R = 128) for three
# utterances of the batch of 32 (a cut for CPU time only), against
# ``backward_plain`` at the f32 bar of the card's kernels: atol 1e-4 + rtol
# 1e-5 on every gradient.

TB, TN, TLEN = 3, 4, 199


def emulated_backward(q, kv, p, u, v, lens, ctx, m, den, dctx, mode: str):
    """The kernels' backward algorithm with its products formed as ``mode``
    says: (dq, dkv, dp, du, dv) in f32 (f64 for "f64")."""
    from chunkformer_tpu_torch.ops.chunk_attention_train import _valid

    f = torch.float64 if mode == "f64" else torch.float32
    b, tp, heads, d_k = q.shape
    scale = 1.0 / math.sqrt(d_k)
    win = kv.unfold(1, W, C)                                       # [B, n, H, 2dk, W]
    k = win[:, :, :, :d_k].transpose(-1, -2)                       # [B, n, H, W, dk]
    vals = win[:, :, :, d_k:].transpose(-1, -2)
    qc = q.reshape(b, TN, C, heads, d_k).permute(0, 1, 3, 2, 4)   # [B, n, H, c, dk]
    g = dctx.reshape(b, TN, C, heads, d_k).permute(0, 1, 3, 2, 4)
    ph = p.permute(1, 0, 2)[None, None].expand(b, TN, -1, -1, -1)  # [B, n, H, P, dk]
    uk = k.to(f) @ u.to(f)[None, None, :, :, None]                 # [B, n, H, W, 1]
    vp = ph.to(f) @ v.to(f)[None, None, :, :, None]                # [B, n, H, P, 1]
    s = (product(qc, k, mode).to(f) + uk.transpose(-1, -2)
         + rel_shift(product(qc, ph, mode).to(f) + vp.transpose(-1, -2), L, R)) * scale
    valid = _valid(lens, TN, C, L, W)
    stat = lambda x: x.reshape(b, heads, TN, C).permute(0, 2, 1, 3)[..., None].to(f)  # noqa: E731
    attn = torch.exp(s.masked_fill(~valid, -1e30) - stat(m)) / stat(den)
    delta = (dctx.to(f) * ctx.to(f)).sum(-1).reshape(b, TN, C, heads).permute(0, 1, 3, 2)
    ds = attn * (product(g, vals, mode).to(f) - delta[..., None])  # [B, n, H, c, W]
    idx = C - 1 - torch.arange(C)[:, None] + torch.arange(W)[None, :]
    band = ds.new_zeros(b, TN, heads, C, ph.shape[-2])
    band.scatter_(-1, idx.expand(b, TN, heads, C, W), ds)          # [B, n, H, c, P]
    dq = (product(ds, k.transpose(-1, -2), mode).to(f)
          + product(band, ph.transpose(-1, -2), mode).to(f)) * scale
    cs = ds.sum(-2)                                                # [B, n, H, W]
    dkeys = (product(ds.transpose(-1, -2), qc.transpose(-1, -2), mode).to(f)
             + cs[..., None] * u.to(f)[None, None, :, None, :]) * scale
    dvals = product(attn.transpose(-1, -2), g.transpose(-1, -2), mode).to(f)
    cs_band = band.sum(-2)                                         # [B, n, H, P]
    dp = (product(band.transpose(-1, -2), qc.transpose(-1, -2), mode).to(f).sum((0, 1))
          + cs_band.sum((0, 1))[..., None] * v.to(f)[:, None, :]) * scale   # [H, P, dk]
    du = (cs[..., None] * k.to(f)).sum((0, 1, 3)) * scale
    dv = (cs_band[..., None] * ph.to(f)).sum((0, 1, 3)) * scale
    dwin = torch.cat([dkeys, dvals], -1)                           # [B, n, H, W, 2dk]
    dkv = torch.zeros(kv.shape, dtype=f)
    for i in range(TN):
        dkv[:, i * C:i * C + W] += dwin[:, i].transpose(1, 2)
    dkv[:, :L] = 0.0
    dkv[:, L + TN * C:] = 0.0
    return (dq.permute(0, 1, 3, 2, 4).reshape(q.shape), dkv, dp.transpose(0, 1), du, dv)


@pytest.fixture(scope="module")
def train_case():
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    rng = np.random.default_rng(20261018)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    kv = rnd(TB, L + TN * C + R, H, 2 * DK)
    kv[:, :L] = 0
    kv[:, L + TN * C:] = 0
    args = [rnd(TB, TN * C, H, DK), kv, rnd(2 * C - 1 + L + R, H, DK), rnd(H, DK), rnd(H, DK),
            torch.full((TB,), TLEN, dtype=torch.int32)]
    ctx, m, den = cat.forward_plain(*args, 0, C, L, R, 0.0)
    dctx = rnd(*ctx.shape)
    plain = cat.backward_plain(*args, m, den, dctx, 0, C, L, R, 0.0)
    return args, (ctx, m, den, dctx), plain


def _misses(got, want):
    """max over the gradients of |got - want| - (1e-4 + 1e-5 |want|): <= 0 holds the bar"""
    return max(float(((a.double() - e.double()).abs() - (1e-4 + 1e-5 * e.double().abs())).max())
               for a, e in zip(got, want))


def test_backward_split_holds_the_f32_bar(train_case):
    args, (ctx, m, den, dctx), plain = train_case
    got = emulated_backward(*args, ctx, m, den, dctx, "split")
    exact = emulated_backward(*args, ctx, m, den, dctx, "f64")
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _misses(got, plain) <= 0.0
    assert _misses(got, exact) <= 0.0
    assert _misses(plain, exact) <= 0.0   # the plain version itself, for scale


def test_backward_single_tf32_pass_misses_the_f32_bar(train_case):
    args, (ctx, m, den, dctx), plain = train_case
    got = emulated_backward(*args, ctx, m, den, dctx, "single")
    worst = max(float((a.double() - e.double()).abs().max()) for a, e in zip(got, plain))
    assert _misses(got, plain) > 0.0, worst
    assert worst < 1.0, worst  # still the same function: the error is rounding, not a fault
