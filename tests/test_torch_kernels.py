"""The port's kernel-holding modules (chunk attention, fbank) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them. The CUDA kernels themselves are held against
these plain versions on a card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.ops.fbank import fbank as jax_fbank
from chunkformer_tpu.ops.pallas.chunk_attention import (
    chunk_attention_pallas, chunk_attention_pallas_union_hmajor)
from chunkformer_tpu.ops.pallas.fbank import fbank_pallas
from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
from chunkformer_tpu_torch.ops.fbank import fbank, fbank_plain


def _attention_inputs(seed, n, c, heads, d_k, L, R, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, heads, c, d_k)).astype(dtype)            # head-major
    kv = rng.normal(size=(heads, L + n * c + R, 2 * d_k)).astype(dtype)
    p = rng.normal(size=(heads, 2 * c - 1 + L + R, d_k)).astype(dtype)
    u = rng.normal(size=(heads, d_k)).astype(dtype)
    v = rng.normal(size=(heads, d_k)).astype(dtype)
    # rows of two utterances with an offset, a partial tail and a padding row
    ci = np.concatenate([np.arange(n - n // 3 - 1), np.arange(n // 3), [0]]).astype(np.int32)
    off = np.where(np.arange(n) < n - n // 3 - 1, 3, 0).astype(np.int32)
    ml = np.where(np.arange(n) < n - n // 3 - 1, (n - n // 3 - 1) * c - 5, n // 3 * c - 2)
    ml = ml.astype(np.int32)
    ml[-1] = 0
    return q, kv, p, u, v, ci, off, ml


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,c,L,R", [(8, 8, 16, 16), (16, 8, 16, 0), (8, 4, 8, 8)])
def test_chunk_attention_matches_union_hmajor_kernel(n, c, L, R):
    """Head-major contract (N % 8 == 0), passed as transposed views.
    Tolerance f32 atol 1e-5: the JAX kernels' own bar; the union kernel folds
    1/sqrt(dk) before its products, the plain version scales after them."""
    heads, d_k = 4, 16
    q, kv, p, u, v, ci, off, ml = _attention_inputs(0, n, c, heads, d_k, L, R)
    want = chunk_attention_pallas_union_hmajor(
        *map(jnp.asarray, (q, kv, p, u, v, ci, off, ml)),
        chunk=c, left=L, right=R, g=8, interpret=True)
    tq, tkv, tp, tu, tv, tci, toff, tml = _torch(q, kv, p, u, v, ci, off, ml)
    got = chunk_attention(tq.transpose(1, 2), tkv.transpose(0, 1), tp.transpose(0, 1),
                          tu, tv, tci, toff, tml, chunk=c, left=L, right=R)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n", [13, 5])
def test_chunk_attention_matches_per_chunk_kernel_at_odd_n(n):
    """Row-major contract at odd N, against the per-chunk kernel; f32 atol 1e-5."""
    c, L, R, heads, d_k = 8, 16, 16, 4, 16
    q, kv, p, u, v, ci, off, ml = _attention_inputs(1, n, c, heads, d_k, L, R)
    q, kv, p = q.transpose(0, 2, 1, 3), kv.transpose(1, 0, 2), p.transpose(1, 0, 2)
    want = chunk_attention_pallas(*map(jnp.asarray, (q, kv, p, u, v, ci, off, ml)),
                                  chunk=c, left=L, right=R, interpret=True)
    got = chunk_attention(*_torch(q, kv, p, u, v, ci, off, ml), chunk=c, left=L, right=R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n_samples", [16000 + 123, 400, 100])
def test_fbank_matches_jax(n_samples):
    """Against fbank_pallas (interpret) and the XLA FFT fbank. Tolerance
    atol 2e-3 / rtol 1e-3, the JAX package's own bar (tests/test_fbank.py):
    two float32 DFT/FFT summation orders of int16-scale audio before a log."""
    wave = (np.random.default_rng(3).normal(size=n_samples) * 8000).astype(np.float32)
    got = fbank(torch.from_numpy(wave)).numpy()
    for want in (np.asarray(fbank_pallas(jnp.asarray(wave), interpret=True)),
                 np.asarray(jax_fbank(jnp.asarray(wave)))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_wrappers_on_cpu_run_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    before = (chunk_attention.launches, fbank.launches, fbank.fft_launches)
    wave = torch.from_numpy((np.random.default_rng(4).normal(size=4000) * 8000)
                            .astype(np.float32))
    assert torch.equal(fbank(wave), fbank_plain(wave))
    args = _torch(*_attention_inputs(2, 8, 4, 2, 8, 8, 8))
    args = [args[0].transpose(1, 2), args[1].transpose(0, 1), args[2].transpose(0, 1), *args[3:]]
    assert torch.equal(chunk_attention(*args, chunk=4, left=8, right=8),
                       chunk_attention_plain(*args, chunk=4, left=8, right=8))
    assert (chunk_attention.launches, fbank.launches, fbank.fft_launches) == before
