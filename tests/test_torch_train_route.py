"""Route choice of the training attention, on the CPU (no JAX, no card).

``ops/chunk_attention_train.py:route`` sends f32 or bf16 with head_dim 64 or
128, any chunk > 0 (a chunk that 64 does not divide ends in a partial 64-row
query block) and 16-byte-aligned rows to the tensor-core kernels (bf16
kernels, or the 3xTF32 f32 kernels), everything else to the CUDA-core
kernels; it decides from dtype, shapes and strides alone. A CPU
tensor runs the plain versions and never builds or loads the kernel library.
"""

import math

import pytest
import torch

from chunkformer_tpu_torch.ops import chunk_attention_train as cat
from chunkformer_tpu_torch.ops import kernels


def _operands(dtype, d_k, c, b=2, n=3, heads=4, left=None, right=None):
    left = 2 * c if left is None else left
    right = 2 * c if right is None else right
    q = torch.zeros(b, n * c, heads, d_k, dtype=dtype)
    kv = torch.zeros(b, left + n * c + right, heads, 2 * d_k, dtype=dtype)
    p = torch.zeros(2 * c - 1 + left + right, heads, d_k, dtype=dtype)
    return q, kv, p


def _counts():
    f = cat.chunk_train_attention
    return (f.fwd_launches, f.bwd_launches, f.fwd_tc_launches, f.bwd_tc_launches)


@pytest.mark.parametrize("dtype,d_k,c,left,right,want", [
    (torch.bfloat16, 64, 64, 128, 128, "tensor_core"),   # the flagship train shape
    (torch.bfloat16, 128, 64, 128, 128, "tensor_core"),
    (torch.bfloat16, 64, 128, 64, 0, "tensor_core"),
    (torch.bfloat16, 64, 64, 0, 64, "tensor_core"),
    (torch.float32, 64, 64, 128, 128, "tensor_core"),    # f32 at the flagship shape: 3xTF32
    (torch.float32, 128, 128, 64, 0, "tensor_core"),
    (torch.float32, 32, 64, 128, 128, "cuda_core"),      # f32, head_dim not 64 or 128
    (torch.float32, 64, 32, 64, 64, "tensor_core"),      # f32, a partial block of 32 rows
    (torch.float32, 16, 8, 16, 16, "cuda_core"),
    (torch.bfloat16, 32, 64, 128, 128, "cuda_core"),     # head_dim not 64 or 128
    (torch.bfloat16, 16, 8, 16, 16, "cuda_core"),        # the CPU tests' small shapes
    (torch.bfloat16, 64, 32, 64, 64, "tensor_core"),     # a partial block of 32 rows
    (torch.bfloat16, 64, 96, 64, 64, "tensor_core"),     # 64 + 32 rows
    (torch.bfloat16, 128, 48, 128, 128, "tensor_core"),
    (torch.float32, 64, 72, 64, 0, "tensor_core"),       # 64 + 8 rows
    (torch.float32, 128, 16, 64, 64, "tensor_core"),
    (torch.bfloat16, 64, 1, 2, 2, "tensor_core"),
    (torch.bfloat16, 256, 96, 64, 64, "cuda_core"),      # head_dim 256
])
def test_train_route_choice(dtype, d_k, c, left, right, want):
    q, kv, p = _operands(dtype, d_k, c, left=left, right=right)
    launches = _counts()
    assert cat.route(q, kv, p, c) == want
    # the same operands in head-major storage, as transposed views: same choice
    assert cat.route(q.transpose(1, 2).contiguous().transpose(1, 2),
                     kv.transpose(1, 2).contiguous().transpose(1, 2),
                     p.transpose(0, 1).contiguous().transpose(0, 1), c) == want
    assert _counts() == launches


def test_train_route_misaligned_storage_offset():
    """A view that starts 2 bytes into its storage cannot take 16-byte copies."""
    q, kv, p = _operands(torch.bfloat16, 64, 64)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    q_off = flat[1:].view(q.shape)
    assert q_off.data_ptr() % 16 != 0
    assert cat.route(q_off, kv, p, 64) == "cuda_core"
    p_flat = torch.zeros(p.numel() + 8, dtype=torch.bfloat16)
    assert cat.route(q, kv, p_flat[8:].view(p.shape), 64) == "tensor_core"   # 16 bytes in
    assert cat.route(q, kv, p_flat[4:p.numel() + 4].view(p.shape), 64) == "cuda_core"


def test_train_route_f32_misaligned_rows():
    """f32 rows take 16-byte copies too: a view 4 bytes into its storage, or
    row strides that are not a multiple of 4 elements, go to the CUDA cores;
    16 bytes in, or a 16-byte-multiple stride, stays on the tensor cores."""
    q, kv, p = _operands(torch.float32, 64, 64)
    flat = torch.zeros(q.numel() + 4, dtype=torch.float32)
    assert cat.route(flat[1:q.numel() + 1].view(q.shape), kv, p, 64) == "cuda_core"
    assert cat.route(flat[4:].view(q.shape), kv, p, 64) == "tensor_core"
    wide = torch.zeros(*kv.shape[:3], 2 * 64 + 4, dtype=torch.float32)
    assert cat.route(q, wide[..., :128], p, 64) == "tensor_core"   # rows 528 bytes apart
    odd = torch.zeros(*kv.shape[:3], 2 * 64 + 2, dtype=torch.float32)
    assert cat.route(q, odd[..., :128], p, 64) == "cuda_core"      # rows 520 bytes apart
    odd_p = torch.zeros(*p.shape[:2], 64 + 1, dtype=torch.float32)
    assert cat.route(q, kv, odd_p[..., :64], 64) == "cuda_core"


def test_train_route_strided_views():
    """Row strides that are not a multiple of 8 elements (16 bytes) go to the
    CUDA cores; views that keep them aligned stay on the tensor cores."""
    q, kv, p = _operands(torch.bfloat16, 64, 64)
    wide = torch.zeros(*kv.shape[:3], 2 * 64 + 8, dtype=torch.bfloat16)
    assert cat.route(q, wide[..., :128], p, 64) == "tensor_core"   # rows 272 bytes apart
    odd = torch.zeros(*kv.shape[:3], 2 * 64 + 4, dtype=torch.bfloat16)
    assert cat.route(q, odd[..., :128], p, 64) == "cuda_core"      # rows 264 bytes apart
    odd_q = torch.zeros(*q.shape[:3], 64 + 3, dtype=torch.bfloat16)
    assert cat.route(odd_q[..., :64], kv, p, 64) == "cuda_core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_on_cpu_never_loads_kernels(monkeypatch, dtype):
    """On a CPU tensor the forward and backward are the plain versions: the
    kernel library is neither built nor loaded, and no counter moves, even
    where the operands would route to the tensor cores on a card."""
    def no_library():
        raise AssertionError("kernels.library() called for a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_library)
    monkeypatch.setattr(kernels, "build", no_library)
    g = torch.Generator().manual_seed(0)
    c, left, right, d_k, heads = 64, 64, 0, 64, 2
    q, kv, p = (torch.randn(t.shape, generator=g).to(dtype)
                for t in _operands(dtype, d_k, c, b=2, n=2, heads=heads, left=left,
                                   right=right))
    kv[:, :left] = 0
    u, v = torch.randn(heads, d_k, generator=g).to(dtype), torch.randn(heads, d_k,
                                                                       generator=g).to(dtype)
    lens = torch.tensor([128, 70], dtype=torch.int32)
    assert cat.route(q, kv, p, c) == "tensor_core"
    leaves = [t.clone().requires_grad_() for t in (q, kv, p, u, v)]
    launches = _counts()
    out = cat.chunk_train_attention(*leaves, lens, 5, chunk=c, left=left, right=right,
                                    drop_rate=0.1)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert _counts() == launches
    assert out.shape == q.shape and all(bool(torch.isfinite(x).all()) for x in grads)


@pytest.mark.parametrize("entry", ["chunk_train_attention_cuda_core",
                                   "chunk_train_attention_tensor_core"])
def test_train_route_entries_raise_on_cpu(monkeypatch, entry):
    """The per-route entries launch their kernels on CUDA tensors only: on a
    CPU tensor they raise before the library is touched."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("library() called"))
    q, kv, p = _operands(torch.bfloat16, 64, 64)
    u = v = torch.zeros(4, 64, dtype=torch.bfloat16)
    lens = torch.tensor([100, 192], dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        getattr(cat, entry)(q, kv, p, u, v, lens, chunk=64, left=128, right=128)


def test_tensor_core_route_refuses_what_it_cannot_take():
    """Naming the tensor-core route for operands it cannot take raises (no
    fallback to the CUDA cores), in f32 as in bf16; the CUDA-core route
    takes c * dk > 4096 (in slices of at most 4096 / dk query rows a block,
    each with its own dP / du / dv partials)."""
    q, kv, p = _operands(torch.float32, 32, 64)
    with pytest.raises(ValueError, match="tensor-core"):
        cat._check_path("tensor_core", q, kv, p, 64, 32)
    q, kv, p = _operands(torch.bfloat16, 256, 32)
    with pytest.raises(ValueError, match="tensor-core"):
        cat._check_path("tensor_core", q, kv, p, 32, 256)
    q, kv, p = _operands(torch.bfloat16, 64, 32)   # a partial 64-row block: taken
    cat._check_path("tensor_core", q, kv, p, 32, 64)
    q, kv, p = _operands(torch.float32, 64, 64)
    cat._check_path("tensor_core", q, kv, p, 64, 64)
    q, kv, p = _operands(torch.bfloat16, 128, 128)
    cat._check_path("tensor_core", q, kv, p, 128, 128)
    cat._check_path("cuda_core", q, kv, p, 128, 128)
    assert cat.cuda_core_slices(128, 128) == 4 and cat.cuda_core_slices(64, 64) == 1
    assert cat.partial_shapes("cuda_core", 2, 3, 4, 128, 383, 128)[0][0] == (2 * 3 * 4 * 4,
                                                                             383, 128)
    with pytest.raises(ValueError, match="path"):
        cat._check_path("auto", q, kv, p, 128, 128)


def test_tensor_core_backward_partials_fit_budget():
    """At the flagship shape (B = 32, n = 4, c = 64, H = 8, P = 383, dk = 64)
    the f32 partial buffers of the tensor-core backward take at most 25 MB:
    two utterances a dq block, 16 dP slabs of [H, P, dk] (12.55 MB) with
    their column sums, and a du partial per 64 key frames; the CUDA-core
    route's per-(b, ci, h) slabs take 100 MB. A small batch gets one
    utterance a block."""
    b, n, c, heads, p_len, d_k = 32, 4, 64, 8, 383, 64

    def nbytes(path):
        return sum(4 * math.prod(s) for s, _ in cat.partial_shapes(path, b, n, heads, c,
                                                                    p_len, d_k))

    assert cat.dp_group(b, heads, p_len, d_k) == 2
    assert nbytes("tensor_core") <= 25e6
    assert nbytes("cuda_core") > 100e6
    shapes = cat.partial_shapes("tensor_core", b, n, heads, c, p_len, d_k)
    assert shapes[0] == ((16, 8, 383, 64), True)
    # the kernels add into the dP slabs and column sums only: those start zeroed
    assert [zeroed for _, zeroed in shapes] == [True, True, False]
    assert not any(zeroed for _, zeroed in cat.partial_shapes("cuda_core", b, n, heads, c,
                                                             p_len, d_k))
    assert cat.dp_group(4, 8, 383, 64) == 1
    assert cat.dp_group(1, 8, 383, 128) == 1
