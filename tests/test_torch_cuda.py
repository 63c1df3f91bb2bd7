"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda`` and skipped without one. This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
from chunkformer_tpu_torch.ops.fbank import fbank, fbank_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attention_args(n, c, L, R, heads, d_k, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    q, kv = rnd(n, c, heads, d_k), rnd(L + n * c + R, heads, 2 * d_k)
    p, u, v = rnd(2 * c - 1 + L + R, heads, d_k), rnd(heads, d_k), rnd(heads, d_k)
    # two utterances (the first with a decode offset), then one padding row
    n1 = n - n // 3 - 1
    ci = list(range(n1)) + list(range(n // 3)) + [0]
    off = [3] * n1 + [0] * (n // 3) + [0]
    ml = [n1 * c - 5] * n1 + [n // 3 * c - 2] * (n // 3) + [0]
    meta = [torch.tensor(a, dtype=torch.int32, device=device) for a in (ci, off, ml)]
    return [q, kv, p, u, v, *meta]


@pytest.mark.parametrize("dtype,n,c,L,R,d_k,atol", [
    (torch.float32, 16, 64, 128, 128, 64, 1e-5),
    (torch.float32, 13, 64, 128, 128, 64, 1e-5),
    (torch.float32, 9, 8, 16, 0, 16, 1e-5),
    (torch.bfloat16, 16, 64, 128, 128, 64, 1e-2),
])
def test_chunk_attention_kernel_matches_plain(cuda_device, dtype, n, c, L, R, d_k, atol):
    """f32: atol 1e-5 (summation order only). bf16: atol 1e-2 plus one bf16
    ulp (2^-7) relative: both sides accumulate in f32 and round once."""
    args = _attention_args(n, c, L, R, 8, d_k, dtype, cuda_device)
    kw = dict(chunk=c, left=L, right=R)
    launches = chunk_attention.launches
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert chunk_attention.launches == launches + 1
    want = chunk_attention_plain(*args, **kw)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_chunk_attention_kernel_takes_head_major_views(cuda_device):
    """The TPU kernel's head-major layout, passed as transposed views."""
    args = _attention_args(8, 64, 128, 128, 8, 64, torch.float32, cuda_device, seed=1)
    q_hm = args[0].transpose(1, 2).contiguous()    # [N, H, c, dk]
    kv_hm = args[1].transpose(0, 1).contiguous()   # [H, L + N*c + R, 2dk]
    p_hm = args[2].transpose(0, 1).contiguous()    # [H, 2c - 1 + L + R, dk]
    q, kv, p = q_hm.transpose(1, 2), kv_hm.transpose(0, 1), p_hm.transpose(0, 1)
    assert not q.is_contiguous() and not kv.is_contiguous()
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention(q, kv, p, *args[3:], **kw)
    torch.testing.assert_close(got, chunk_attention_plain(*args, **kw), atol=1e-5, rtol=0)


def test_fbank_kernel_matches_plain(cuda_device):
    """atol 2e-3 / rtol 1e-3, the bar the JAX package holds its kernel to."""
    wave = torch.from_numpy((np.random.default_rng(6).normal(size=16000 * 30 + 123) * 8000)
                            .astype(np.float32)).to(cuda_device)
    launches = fbank.launches
    got = fbank(wave)
    torch.cuda.synchronize()
    assert fbank.launches == launches + 1
    torch.testing.assert_close(got, fbank_plain(wave), atol=2e-3, rtol=1e-3)
