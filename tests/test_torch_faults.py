"""Repairs of the port's own faults, on the CPU, at a tiny size (2 layers,
64 d, 4 heads, conv kernel 15, c 8, L = R = 16). The JAX package cannot be
the oracle here: it drops the batch-norm statistics of a train step and
raises on a causal chunked conv, so each test names its own oracle.

- Batch-norm running statistics: after one ``make_train_step`` step each
  conv module's running mean and variance hold exactly one momentum update,
  the one that ``batch_norm_train`` returned for that step's forward (not a
  recompute's, and not applied twice), under each checkpoint policy and
  without checkpointing; rtol 1e-6 (the same f32 values, copied).
- Causal ``dynamic_conv`` with ``chunk_size > 0``: each chunk's depthwise
  conv sees its k - 1 real left frames and no right frames; oracle
  ``F.conv1d`` on each chunk's [k - 1 left frames | chunk], f32 atol 1e-6.
- The chunk attention wrapper's route choice, decided from dtype and shapes
  without launching anything.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
from chunkformer_tpu_torch.nn import convolution
from chunkformer_tpu_torch.nn.convolution import ConvolutionModule
from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention, route
from chunkformer_tpu_torch.train.optim import build_optimizer
from chunkformer_tpu_torch.train.train_step import make_train_step

C, L, R = 8, 16, 16
VOCAB = 40


def _config(remat):
    enc = {"output_size": 64, "attention_heads": 4, "linear_units": 128, "num_blocks": 2,
           "cnn_module_kernel": 15, "cnn_module_norm": "batch_norm", "dynamic_conv": True,
           "gradient_checkpointing": remat is not None, "dropout_rate": 0.0,
           "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0}
    if remat is not None:
        enc["remat_policy"] = remat
    return {"model": "asr_model", "encoder_conf": enc, "decoder": "bitransformer",
            "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                             "r_num_blocks": 1, "dropout_rate": 0.0,
                             "positional_dropout_rate": 0.0},
            "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
            "output_dim": VOCAB}


@pytest.mark.parametrize("remat", ["nothing", "dots", None])
def test_train_step_updates_batch_norm_statistics_once(monkeypatch, remat):
    cfg = ChunkFormerConfig.from_dict(_config(remat))
    model = init_random_(ASRModel(cfg, cmvn=False), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    norms = [layer.conv_module.norm for layer in model.encoder.encoders]
    with torch.no_grad():  # non-trivial statistics, so the momentum shows
        for norm in norms:
            norm.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.3, 64).astype(np.float32)))
            norm.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32)))
    before = [(n.running_mean.clone(), n.running_var.clone()) for n in norms]

    calls = {id(n): [] for n in norms}
    orig = convolution.batch_norm_train

    def recording(norm, x, *a, **k):
        y, stats = orig(norm, x, *a, **k)
        calls[id(norm)].append((x.detach().clone(), {s: t.clone() for s, t in stats.items()}))
        return y, stats

    monkeypatch.setattr(convolution, "batch_norm_train", recording)
    feats = torch.from_numpy(rng.normal(size=(2, 120, 80)).astype(np.float32))
    lens = torch.tensor([120, 77], dtype=torch.int32)
    tgts = torch.from_numpy(rng.integers(1, VOCAB - 2, size=(2, 6)).astype(np.int64))
    tlens = torch.tensor([6, 4], dtype=torch.int32)
    tgts[1, 4:] = -1
    params = list(model.parameters())
    opt, sched = build_optimizer(params, "adamw", {"lr": 1e-3}, "warmuplr",
                                 {"warmup_steps": 2})
    assert not any(b is p for n in norms for b in (n.running_mean, n.running_var)
                   for p in params)  # the buffers stay out of the optimizer
    make_train_step(model, cfg, opt, sched, (C, L, R))(feats, lens, tgts, tlens)

    for norm, (mean0, var0) in zip(norms, before):
        seen = calls[id(norm)]
        # the forward, plus the recompute in the backward under checkpointing
        assert len(seen) == (1 if remat is None else 2)
        x, stats = seen[0]
        torch.testing.assert_close(norm.running_mean, stats["mean"], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(norm.running_var, stats["var"], rtol=1e-6, atol=0.0)
        assert int(norm.num_batches_tracked) == 1
        # ... and that is one momentum update (0.1) of the initial values by
        # the step's batch statistics (unbiased variance), computed in f64
        xd = x.double()
        count = xd.numel() // xd.shape[1]
        mean = xd.mean((0, 2))
        var = xd.var((0, 2), unbiased=False) * count / (count - 1)
        torch.testing.assert_close(norm.running_mean.double(), 0.9 * mean0.double() + 0.1 * mean,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(norm.running_var.double(), 0.9 * var0.double() + 0.1 * var,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,c", [(15, 8), (7, 4), (15, 16)])
def test_causal_dynamic_conv_matches_per_chunk_conv(k, c):
    torch.manual_seed(k * 100 + c)
    d, t = 32, 45  # 45 frames: not a multiple of any chunk size here
    m = ConvolutionModule(d, k, "layer_norm").eval()
    x = torch.randn(2, t, d)
    mask = torch.arange(t)[None, :] < torch.tensor([t, 30])[:, None]
    with torch.no_grad():
        got, stats = m.full(x, mask, chunk_size=c, causal=True)

        h = F.glu(F.linear(x.masked_fill(~mask[:, :, None], 0.0), m.pointwise_conv1.weight[:, :, 0],
                           m.pointwise_conv1.bias), dim=-1).transpose(1, 2)   # [B, D, T]
        n = -(-t // c)
        hp = F.pad(h, (k - 1, n * c - t))
        y = torch.cat([F.conv1d(hp[:, :, i * c:i * c + k - 1 + c], m.depthwise_conv.weight,
                                m.depthwise_conv.bias, groups=d) for i in range(n)], dim=2)
        want, _ = m._post(y[:, :, :t], train=False)
        want = want.masked_fill(~mask[:, :, None], 0.0)
    assert stats is None and got.shape == (2, t, d)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0.0)


@pytest.mark.parametrize("dtype,c,d_k,want", [
    (torch.bfloat16, 64, 64, "tensor_core"),
    (torch.float32, 64, 64, "tensor_core"),
    (torch.bfloat16, 8, 64, "tensor_core"),
    (torch.float32, 8, 64, "tensor_core"),
    (torch.float32, 64, 128, "tensor_core"),
    (torch.float32, 64, 32, "cuda_core"),
    *[(dtype, c, d_k, "tensor_core") for c in (96, 48, 72, 16) for d_k in (64, 128)
      for dtype in (torch.float32, torch.bfloat16)],
    (torch.bfloat16, 96, 32, "cuda_core"),
    (torch.float32, 48, 256, "cuda_core"),
])
def test_chunk_attention_route_choice(dtype, c, d_k, want):
    """f32 or bf16 at head_dim 64 or 128 takes the tensor cores (3xTF32 for
    f32) at any chunk size, a partial 64-row query tile covering what 64
    does not divide; another head_dim the CUDA-core kernel. Nothing is
    launched."""
    n, heads, left, right = 3, 8, 2 * c, 2 * c
    q = torch.zeros(n, c, heads, d_k, dtype=dtype)
    kv = torch.zeros(left + n * c + right, heads, 2 * d_k, dtype=dtype)
    p = torch.zeros(2 * c - 1 + left + right, heads, d_k, dtype=dtype)
    launches = (chunk_attention.launches, chunk_attention.tc_launches)
    assert route(q, kv, p) == want
    # the head-major layout as views: the same choice
    assert route(q.transpose(1, 2).contiguous().transpose(1, 2),
                 kv.transpose(0, 1).contiguous().transpose(0, 1), p) == want
    assert (chunk_attention.launches, chunk_attention.tc_launches) == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_route_needs_16_byte_rows(dtype):
    """A row stride that is not a multiple of 16 bytes, or a storage offset
    that misaligns the rows, sends the main path's shape to the CUDA-core
    kernel, in either dtype (4 f32 or 8 bf16 elements make 16 bytes)."""
    n, c, heads, d_k, left, right = 3, 64, 8, 64, 128, 128
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    kv = torch.zeros(left + n * c + right, heads, 2 * d_k, dtype=dtype)
    p = torch.zeros(2 * c - 1 + left + right, heads, d_k, dtype=dtype)
    # q rows one element wider than dk: a stride off the 16-byte grid
    wide = torch.zeros(n, c, heads, d_k + 1, dtype=dtype)[..., :d_k]
    assert wide.stride(2) % per16 != 0 and route(wide, kv, p) == "cuda_core"
    # rows 16 bytes wider: aligned again
    padded = torch.zeros(n, c, heads, d_k + per16, dtype=dtype)[..., :d_k]
    assert route(padded, kv, p) == "tensor_core"
    # a storage offset of one element: misaligned data pointer
    flat = torch.zeros(n * c * heads * d_k + 1, dtype=dtype)
    shifted = flat[1:].view(n, c, heads, d_k)
    assert shifted.data_ptr() % 16 != 0 and route(shifted, kv, p) == "cuda_core"


@pytest.mark.parametrize("c", [96, 48, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_route_needs_16_byte_rows_at_any_chunk(dtype, c):
    """The same at chunks that 64 does not divide, which take the tensor
    cores with aligned rows: a row stride off the 16-byte grid in q, kv or
    p, or a misaligned data pointer, keeps them on the CUDA-core kernel."""
    n, heads, d_k, left, right = 3, 8, 64, 2 * c, c
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    q = torch.zeros(n, c, heads, d_k, dtype=dtype)
    kv = torch.zeros(left + n * c + right, heads, 2 * d_k, dtype=dtype)
    p = torch.zeros(2 * c - 1 + left + right, heads, d_k, dtype=dtype)
    assert route(q, kv, p) == "tensor_core"
    wide_kv = torch.zeros(left + n * c + right, heads, 2 * d_k + 1, dtype=dtype)[..., :2 * d_k]
    assert route(q, wide_kv, p) == "cuda_core"
    wide_p = torch.zeros(2 * c - 1 + left + right, heads, d_k + 1, dtype=dtype)[..., :d_k]
    assert route(q, kv, wide_p) == "cuda_core"
    flat = torch.zeros(q.numel() + per16 // 2, dtype=dtype)
    shifted = flat[per16 // 2:].view(q.shape)
    assert shifted.data_ptr() % 16 != 0 and route(shifted, kv, p) == "cuda_core"
