"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda`` and skipped without one. This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import math

import numpy as np
import pytest
import torch

from chunkformer_tpu_torch.ops import chunk_attention_train as cat
from chunkformer_tpu_torch.ops.chunk_attention import (chunk_attention,
                                                       chunk_attention_cuda_core,
                                                       chunk_attention_plain, route)
from chunkformer_tpu_torch.ops.fbank import (fbank, fbank_dft, fbank_fft, fbank_plain, num_frames,
                                             route as fbank_route)

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
    counter = "tc_launches" if route(*args[:3]) == "tensor_core" else "launches"
    launches = getattr(chunk_attention, counter)
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(chunk_attention, counter) == launches + 1
    want = chunk_attention_plain(*args, **kw)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_chunk_attention_kernel_takes_head_major_views(cuda_device):
    """The TPU kernel's head-major layout, passed as transposed views (f32 at
    this shape takes the tensor-core route)."""
    args = _attention_args(8, 64, 128, 128, 8, 64, torch.float32, cuda_device, seed=1)
    q_hm = args[0].transpose(1, 2).contiguous()    # [N, H, c, dk]
    kv_hm = args[1].transpose(0, 1).contiguous()   # [H, L + N*c + R, 2dk]
    p_hm = args[2].transpose(0, 1).contiguous()    # [H, 2c - 1 + L + R, dk]
    q, kv, p = q_hm.transpose(1, 2), kv_hm.transpose(0, 1), p_hm.transpose(0, 1)
    assert not q.is_contiguous() and not kv.is_contiguous()
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention(q, kv, p, *args[3:], **kw)
    torch.testing.assert_close(got, chunk_attention_plain(*args, **kw), atol=1e-5, rtol=0)


def _segment_meta(n, c, segment, device):
    """chunk_idx, offsets and max_lens of one utterance's macro-segment:
    "first" (offset 0, so the first rows' left context is invalid, the last
    chunk ragged), "middle" (a decode offset, the last rows' lookahead past
    max_len) or "last" (a decode offset, and max_len halfway, so whole chunk
    rows lie past it and give 0 where they see no valid key)."""
    if segment == "first":
        off, ml = 0, n * c - 5
    elif segment == "middle":
        off, ml = 300, n * c - 37
    else:
        off, ml = 300, max(1, n * c // 2 - 7)
    return [torch.tensor(a, dtype=torch.int32, device=device)
            for a in (list(range(n)), [off] * n, [ml] * n)]


@pytest.mark.parametrize("segment", ["first", "last"])
@pytest.mark.parametrize("L,R", [(128, 128), (64, 0)])
@pytest.mark.parametrize("d_k", [64, 128])
@pytest.mark.parametrize("n", [1, 13, 40])
def test_tensor_core_kernel_matches_plain(cuda_device, n, d_k, L, R, segment):
    """The bf16 tensor-core route (c = 64) against the plain version: atol
    1e-2 plus one bf16 ulp (2^-7) relative, the bf16 bar of the CUDA-core
    kernel (both accumulate in f32; the kernel also rounds the softmax
    weights to bf16 for the context product)."""
    c = 64
    args = _attention_args(n, c, L, R, 8, d_k, torch.bfloat16, cuda_device, seed=n + d_k)
    args[5:] = _segment_meta(n, c, segment, cuda_device)
    assert route(*args[:3]) == "tensor_core"
    kw = dict(chunk=c, left=L, right=R)
    launches = (chunk_attention.launches, chunk_attention.tc_launches)
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (chunk_attention.launches, chunk_attention.tc_launches) == (launches[0],
                                                                       launches[1] + 1)
    want = chunk_attention_plain(*args, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2.0 ** -7)
    if segment == "last" and n > 1:
        assert not bool(got[-1].any())  # past max_len with no valid key: zero rows


@pytest.mark.parametrize("d_k", [64, 128])
def test_tensor_core_kernel_takes_head_major_views(cuda_device, d_k):
    """The TPU kernel's head-major layout, passed as transposed views, gives
    the row-major result on the tensor-core route."""
    args = _attention_args(8, 64, 128, 128, 8, d_k, torch.bfloat16, cuda_device, seed=2)
    q = args[0].transpose(1, 2).contiguous().transpose(1, 2)    # [N, H, c, dk] storage
    kv = args[1].transpose(0, 1).contiguous().transpose(0, 1)   # [H, T, 2dk] storage
    p = args[2].transpose(0, 1).contiguous().transpose(0, 1)    # [H, P, dk] storage
    assert not q.is_contiguous() and route(q, kv, p) == "tensor_core"
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention(q, kv, p, *args[3:], **kw)
    torch.testing.assert_close(got, chunk_attention(*args, **kw), atol=0.0, rtol=0.0)
    torch.testing.assert_close(got.float(), chunk_attention_plain(*args, **kw).float(),
                               atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.parametrize("segment", ["first", "middle", "last"])
@pytest.mark.parametrize("L,R", [(128, 128), (64, 0), (0, 64)])
@pytest.mark.parametrize("c,d_k", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_f32_tensor_core_kernel_matches_plain(cuda_device, c, d_k, L, R, segment):
    """The f32 tensor-core route (3xTF32 split products) against the plain
    f32 version: atol 1e-5, rtol 0, the f32 bar of the CUDA-core kernel and
    of the JAX kernels (tests/test_pallas_attention.py:100-101)."""
    n = 13
    args = _attention_args(n, c, L, R, 8, d_k, torch.float32, cuda_device, seed=n + d_k + c)
    args[5:] = _segment_meta(n, c, segment, cuda_device)
    assert route(*args[:3]) == "tensor_core"
    kw = dict(chunk=c, left=L, right=R)
    launches = (chunk_attention.launches, chunk_attention.tc_launches)
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (chunk_attention.launches, chunk_attention.tc_launches) == (launches[0],
                                                                       launches[1] + 1)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, chunk_attention_plain(*args, **kw), atol=1e-5, rtol=0.0)
    if segment == "last":
        assert not bool(got[-1].any())  # past max_len with no valid key: zero rows


@pytest.mark.parametrize("d_k", [64, 128])
def test_f32_tensor_core_kernel_takes_head_major_views(cuda_device, d_k):
    """The head-major layout as transposed views, f32 on the tensor cores:
    the row-major result exactly, and the plain version within 1e-5."""
    args = _attention_args(8, 64, 128, 128, 8, d_k, torch.float32, cuda_device, seed=4)
    q = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    kv = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    p = args[2].transpose(0, 1).contiguous().transpose(0, 1)
    assert not q.is_contiguous() and route(q, kv, p) == "tensor_core"
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention(q, kv, p, *args[3:], **kw)
    torch.testing.assert_close(got, chunk_attention(*args, **kw), atol=0.0, rtol=0.0)
    torch.testing.assert_close(got, chunk_attention_plain(*args, **kw), atol=1e-5, rtol=0.0)


def test_cuda_core_kernel_takes_bf16_main_path_shapes(cuda_device):
    """The CUDA-core kernel stays right on the bf16 shapes that now route to
    the tensor cores (it is their yardstick in chip_smoke.py)."""
    args = _attention_args(16, 64, 128, 128, 8, 64, torch.bfloat16, cuda_device, seed=3)
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention_cuda_core(*args, **kw)
    torch.testing.assert_close(got.float(), chunk_attention_plain(*args, **kw).float(),
                               atol=1e-2, rtol=2.0 ** -7)


def test_cuda_core_kernel_takes_f32_main_path_shapes(cuda_device):
    """The same for f32, whose main path shapes now take the 3xTF32 kernel."""
    args = _attention_args(16, 64, 128, 128, 8, 64, torch.float32, cuda_device, seed=3)
    kw = dict(chunk=64, left=128, right=128)
    got = chunk_attention_cuda_core(*args, **kw)
    torch.testing.assert_close(got, chunk_attention_plain(*args, **kw), atol=1e-5, rtol=0.0)


# C7: chunks whose c * dk passes the 4096 outputs a CUDA-core block keeps,
# cut into slices of query rows (csrc/chunk_attention.cu); an odd N of rows
C7_SHAPES = [(9, 96, 64), (7, 48, 128), (13, 72, 64)]


@pytest.mark.parametrize("n,c,d_k", C7_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_kernel_takes_any_chunk(cuda_device, n, c, d_k, dtype):
    """c = 96 at dk 64, c = 48 at dk 128 and c = 72 at dk 64 over 13 rows
    on the CUDA-core kernel, launched directly (``route`` sends these shapes
    to the tensor cores), which runs them in slices of query rows; f32 atol
    1e-5, bf16 atol 1e-2 plus one bf16 ulp."""
    L, R = 128, 128
    args = _attention_args(n, c, L, R, 8, d_k, dtype, cuda_device, seed=c + d_k)
    kw = dict(chunk=c, left=L, right=R)
    launches = (chunk_attention.launches, chunk_attention.tc_launches)
    got = chunk_attention_cuda_core(*args, **kw)
    torch.cuda.synchronize()
    assert (chunk_attention.launches, chunk_attention.tc_launches) == (launches[0] + 1,
                                                                       launches[1])
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), chunk_attention_plain(*args, **kw).float(),
                               atol=1e-2 if bf16 else 1e-5, rtol=2.0 ** -7 if bf16 else 0.0)


@pytest.mark.parametrize("segment", ["first", "last"])
@pytest.mark.parametrize("n,c,d_k,L,R", [(9, 96, 64, 128, 128), (8, 48, 128, 128, 128),
                                         (13, 72, 64, 128, 128), (16, 16, 64, 32, 16),
                                         (8, 1, 64, 4, 2), (8, 130, 128, 64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_kernel_takes_any_chunk(cuda_device, n, c, d_k, L, R, segment, dtype):
    """Chunks that 64 does not divide on the tensor cores: ceil(c / 64)
    query tiles a chunk, the last partial (c = 96: 64 + 32 rows; 48, 16 and
    1: one tile at r0 = 0; 72: 64 + 8; 130: 64 + 64 + 2). f32 (3xTF32) atol
    1e-5; bf16 atol 1e-2 plus one bf16 ulp; chunk rows with no valid key
    (past max_len) are 0."""
    args = _attention_args(n, c, L, R, 8, d_k, dtype, cuda_device, seed=c + d_k + L)
    args[5:] = _segment_meta(n, c, segment, cuda_device)
    assert route(*args[:3]) == "tensor_core"
    kw = dict(chunk=c, left=L, right=R)
    launches = (chunk_attention.launches, chunk_attention.tc_launches)
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (chunk_attention.launches, chunk_attention.tc_launches) == (launches[0],
                                                                       launches[1] + 1)
    assert bool(torch.isfinite(got).all())
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), chunk_attention_plain(*args, **kw).float(),
                               atol=1e-2 if bf16 else 1e-5, rtol=2.0 ** -7 if bf16 else 0.0)
    start = torch.arange(n, device=cuda_device) * c
    lo = (L - start - args[6]).clamp(min=0)
    hi = (args[7] - start + L).clamp(max=L + c + R)
    assert not bool(got[hi <= lo].any())
    assert segment == "first" or bool((hi <= lo).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_kernel_takes_head_major_views_at_any_chunk(cuda_device, dtype):
    """c = 96 as head-major transposed views: the row-major result exactly."""
    args = _attention_args(8, 96, 128, 128, 8, 64, dtype, cuda_device, seed=5)
    q = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    kv = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    p = args[2].transpose(0, 1).contiguous().transpose(0, 1)
    assert route(q, kv, p) == "tensor_core"
    kw = dict(chunk=96, left=128, right=128)
    torch.testing.assert_close(chunk_attention(q, kv, p, *args[3:], **kw),
                               chunk_attention(*args, **kw), atol=0.0, rtol=0.0)


def _speech(seconds, device, seed=12, sr=16000):
    """int16-scale speech-like audio as float32 (chip_smoke.py speechlike):
    amplitude-modulated tones over noise, with pauses."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.zeros(n, np.float32)
    for f in rng.uniform(100.0, 3500.0, 5):
        x += np.sin(np.float32(2 * np.pi * f) * t + np.float32(rng.uniform(0, 6)))
    env = (np.sin(np.float32(2 * np.pi * 0.4) * t) > -0.3).astype(np.float32)
    x = env * x * 2500.0 + rng.normal(0.0, 300.0, n).astype(np.float32)
    x = np.clip(x, -32768, 32767).astype(np.int16).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("frame_shift,want", [(10.0, "fft"), (10.0625, "fft")])
def test_fbank_1024_point_window(cuda_device, frame_shift, want):
    """C5: a 50 ms window at 16 kHz (800 samples, padded 1024) on 120 s of
    speech-like audio: the even 160-sample shift and the odd 161-sample
    shift (frames at odd samples) both take the FFT kernel (two
    first-stage butterflies a lane); within atol 2e-3 + rtol 1e-3 of the
    plain version."""
    wave = _speech(120.0, cuda_device)
    kw = dict(frame_length=50.0, frame_shift=frame_shift)
    assert fbank_route(**kw) == want
    before = (fbank.launches, fbank.fft_launches)
    got = fbank(wave, **kw)
    torch.cuda.synchronize()
    moved = (fbank.launches - before[0], fbank.fft_launches - before[1])
    assert moved == ((0, 1) if want == "fft" else (1, 0))
    want_feats = fbank_plain(wave, **kw)
    assert got.shape == want_feats.shape == (num_frames(wave.numel(), 16000, 50.0,
                                                        frame_shift), 80)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want_feats, atol=2e-3, rtol=1e-3)


def test_fbank_kernel_matches_plain(cuda_device):
    """atol 2e-3 / rtol 1e-3, the bar the JAX package holds its kernel to.
    At 16 kHz the routed kernel is the FFT kernel."""
    wave = torch.from_numpy((np.random.default_rng(6).normal(size=16000 * 30 + 123) * 8000)
                            .astype(np.float32)).to(cuda_device)
    launches = (fbank.launches, fbank.fft_launches)
    got = fbank(wave)
    torch.cuda.synchronize()
    assert (fbank.launches, fbank.fft_launches) == (launches[0], launches[1] + 1)
    torch.testing.assert_close(got, fbank_plain(wave), atol=2e-3, rtol=1e-3)


def _wave(n_samples, device, seed=8):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=n_samples) * 8000)
                            .astype(np.float32)).to(device)


@pytest.mark.parametrize("sample_rate", [16000, 8000])
@pytest.mark.parametrize("frames", [0, 1, 15, 16, 17, 33, 12000])
def test_fbank_fft_kernel_matches_plain(cuda_device, sample_rate, frames):
    """The FFT kernel at 0 and 1 frames, one tile of 16 frames and one frame
    either side of it, two tiles and a frame, and 120 s; atol 2e-3 / rtol
    1e-3."""
    shift, win = sample_rate // 100, sample_rate // 40
    n_samples = (frames - 1) * shift + win + 7 if frames else win - 1
    wave = _wave(n_samples, cuda_device)
    got = fbank_fft(wave, sample_rate=sample_rate)
    torch.cuda.synchronize()
    want = fbank_plain(wave, sample_rate=sample_rate)
    assert got.shape == want.shape == (frames, 80) == (num_frames(n_samples, sample_rate), 80)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)


def test_fbank_fft_and_dft_kernels_agree(cuda_device):
    """The same waveform through both kernels, each within the bar of the
    plain version and of each other."""
    wave = _wave(16000 * 20 + 55, cuda_device, seed=9)
    fft, dft = fbank_fft(wave), fbank_dft(wave)
    torch.cuda.synchronize()
    torch.testing.assert_close(fft, dft, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(dft, fbank_plain(wave), atol=2e-3, rtol=1e-3)


def test_fbank_route_counters(cuda_device):
    """fbank() launches the FFT kernel at 8 and 16 kHz (25 ms windows) and at
    a 40 ms shift (640 samples, more than the padded 512), and the DFT
    kernel at 160 mel bins; each counter moves once per launch of its
    kernel and never for the other."""
    wave = _wave(16000 * 3, cuda_device)
    cases = [({}, "fft"), ({"sample_rate": 8000}, "fft"), ({"frame_shift": 40.0}, "fft"),
             ({"num_mel_bins": 160}, "dft")]
    for kwargs, want in cases:
        assert fbank_route(**kwargs) == want
        before = (fbank.launches, fbank.fft_launches)
        got = fbank(wave, **kwargs)
        torch.cuda.synchronize()
        moved = (fbank.launches - before[0], fbank.fft_launches - before[1])
        assert moved == ((0, 1) if want == "fft" else (1, 0)), (kwargs, moved)
        torch.testing.assert_close(got, fbank_plain(wave, **kwargs), atol=2e-3, rtol=1e-3)
    with pytest.raises(ValueError):
        fbank_fft(wave, num_mel_bins=160)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fbank_fft_takes_unaligned_waveforms(cuda_device, offset):
    """A waveform that starts off a 16-byte boundary (a view at 1-3 floats
    in) takes the kernel's 4-byte copies; the values move, the arithmetic
    does not, so the result equals the aligned copy's bit for bit."""
    base = _wave(16000 * 5 + 200, cuda_device, seed=10)
    view = base[offset:]
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    aligned = view.clone()
    assert aligned.data_ptr() % 16 == 0
    got = fbank_fft(view)
    torch.cuda.synchronize()
    assert torch.equal(got, fbank_fft(aligned))
    torch.testing.assert_close(got, fbank_plain(view), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("kwargs", [
    dict(frame_shift=10.0625), dict(frame_length=50.0, frame_shift=10.0625),
    dict(frame_shift=40.0), dict(frame_shift=25.0), dict(sample_rate=44100),
    dict(sample_rate=48000, frame_length=42.6, num_mel_bins=128),
    dict(sample_rate=96000, frame_length=20.0)])
@pytest.mark.parametrize("frames", [1, 3, 17, 4000])
def test_fbank_fft_kernel_takes_the_dft_geometries(cuda_device, kwargs, frames):
    """The geometries the FFT kernel took from the DFT kernel: odd shifts, a
    shift longer than the window (frames copied one by one), frames that
    touch, and 2048-point windows (four warps a block; the DFT kernel
    refuses windows above 907 samples); one frame, a partial tile, two
    tiles and more, against the plain version (atol 2e-3 + rtol 1e-3)."""
    sr = kwargs.get("sample_rate", 16000)
    fl, fs = kwargs.get("frame_length", 25.0), kwargs.get("frame_shift", 10.0)
    win, shift = int(sr * fl * 0.001), int(sr * fs * 0.001)
    n_samples = (frames - 1) * shift + win + 5
    wave = _speech(n_samples / sr + 0.01, cuda_device, seed=frames, sr=sr)[:n_samples]
    wave = wave.contiguous()
    assert fbank_route(**kwargs) == "fft"
    before = (fbank.launches, fbank.fft_launches)
    got = fbank(wave, **kwargs)
    torch.cuda.synchronize()
    assert (fbank.launches - before[0], fbank.fft_launches - before[1]) == (0, 1)
    want = fbank_plain(wave, **kwargs)
    assert got.shape == want.shape == (frames, kwargs.get("num_mel_bins", 80))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("kwargs", [dict(frame_shift=10.0625), dict(frame_shift=40.0),
                                    dict(sample_rate=44100)])
@pytest.mark.parametrize("offset", [1, 3])
def test_fbank_fft_takes_unaligned_waveforms_at_any_shift(cuda_device, kwargs, offset):
    """Odd, long and 2048-point geometries from a waveform off a 16-byte
    boundary (4-byte copies): the aligned copy's result bit for bit."""
    base = _wave(int(kwargs.get("sample_rate", 16000) * 4.5) + 9, cuda_device, seed=11)
    view = base[offset:]
    assert view.data_ptr() % 16 != 0
    got = fbank_fft(view, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, fbank_fft(view.clone(), **kwargs))
    torch.testing.assert_close(got, fbank_plain(view, **kwargs), atol=2e-3, rtol=1e-3)


def _train_attention_args(b, n, c, L, R, heads, d_k, dtype, device, seed=0, lens=None):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    tp = n * c
    kv = rnd(b, L + tp + R, heads, 2 * d_k)
    kv[:, :L] = 0
    kv[:, L + tp:] = 0
    if lens is None:
        lens = [tp - 9 - 7 * i for i in range(b)]
        lens[-1] = c + 3 if b > 1 else lens[-1]
    return [rnd(b, tp, heads, d_k), kv, rnd(2 * c - 1 + L + R, heads, d_k), rnd(heads, d_k),
            rnd(heads, d_k), torch.tensor(lens, dtype=torch.int32, device=device)]


@pytest.mark.parametrize("dtype,b,n,c,L,R,d_k,drop", [
    (torch.float32, 4, 4, 64, 128, 128, 64, 0.0),
    (torch.float32, 3, 5, 8, 16, 0, 16, 0.0),
    (torch.float32, 3, 3, 8, 0, 8, 32, 0.1),
    (torch.float32, 4, 4, 64, 128, 128, 64, 0.1),
    (torch.bfloat16, 4, 4, 64, 128, 128, 64, 0.0),
    (torch.bfloat16, 4, 4, 64, 128, 128, 64, 0.1),
])
def test_train_attention_kernels_match_plain(cuda_device, dtype, b, n, c, L, R, d_k, drop):
    """The CUDA-core route (the route of f32, and the yardstick of the
    tensor-core route on the bf16 main-path shapes): forward kernel (ctx, m,
    den) and backward kernels (grads of q, kv, p, u, v) against the plain
    forward and autograd through it, on the same inputs and the same dropout
    masks. f32: ctx atol 1e-5, m and den rtol 1e-5,
    gradients atol 1e-4 rtol 1e-5 (summation order only; a single dropout
    mask difference would move ctx by a whole weight). bf16: ctx atol 1e-2
    plus one bf16 ulp relative (both accumulate in f32 and round once);
    gradients within 1e-2 relative L2 (the gradients come out in bf16)."""
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device)
    kw = dict(chunk=c, left=L, right=R, drop_rate=drop)
    seed = 1234
    f0, b0 = cat.chunk_train_attention.fwd_launches, cat.chunk_train_attention.bwd_launches
    ctx, m, den = cat.forward_kernel(*args, seed, c, L, R, drop, path="cuda_core")
    torch.cuda.synchronize()
    want_ctx, want_m, want_den = cat.forward_plain(*args, seed, c, L, R, drop)
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(ctx.float(), want_ctx.float(), atol=1e-2 if bf16 else 1e-5,
                               rtol=2.0 ** -7 if bf16 else 0.0)
    torch.testing.assert_close(m, want_m, atol=0.0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(den, want_den, atol=0.0, rtol=1e-2 if bf16 else 1e-5)

    w = torch.randn(ctx.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(3)).to(dtype)
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    out = cat.chunk_train_attention_cuda_core(*leaves, args[5], seed, **kw)
    got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert cat.chunk_train_attention.fwd_launches == f0 + 2
    assert cat.chunk_train_attention.bwd_launches == b0 + 1
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    ref = cat.forward_plain(*leaves, args[5], seed, c, L, R, drop)[0]
    want = torch.autograd.grad((ref.float() * w.float()).sum(), leaves)
    for name, a, e in zip(("q", "kv", "p", "u", "v"), got, want):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        if bf16:
            rel = float((a.float() - e.float()).norm() / e.float().norm())
            assert rel <= 1e-2, (name, rel)
        else:
            torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,L,R,d_k,drop,lens", [
    (3, 3, 96, 128, 128, 64, 0.1, [288, 200, 61]),
    (3, 4, 48, 128, 128, 128, 0.0, [192, 150, 40]),
    (3, 3, 72, 64, 64, 64, 0.0, [216, 143, 1]),
    (2, 3, 16, 16, 16, 256, 0.1, [48, 29]),
])
def test_train_attention_cuda_core_takes_any_chunk(cuda_device, b, n, c, L, R, d_k, drop,
                                                   lens, dtype):
    """C7 for the training kernels: c = 96 / dk 64, c = 48 / dk 128, c = 72
    / dk 64 (lens down to 1) and dk = 256 (the dK/dV kernel's column slices
    and 16-row query tiles) on the CUDA-core route, forward and backward,
    at the bars of ``test_train_attention_kernels_match_plain``."""
    bf16 = dtype == torch.bfloat16
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device, seed=c + d_k,
                                 lens=lens)
    assert cat.route(*args[:3], c) == "cuda_core"
    kw = dict(chunk=c, left=L, right=R, drop_rate=drop)
    seed = 99
    ctx, m, den = cat.forward_kernel(*args, seed, c, L, R, drop, path="cuda_core")
    torch.cuda.synchronize()
    want_ctx, want_m, want_den = cat.forward_plain(*args, seed, c, L, R, drop)
    torch.testing.assert_close(ctx.float(), want_ctx.float(), atol=1e-2 if bf16 else 1e-5,
                               rtol=2.0 ** -7 if bf16 else 0.0)
    torch.testing.assert_close(m, want_m, atol=0.0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(den, want_den, atol=0.0, rtol=1e-2 if bf16 else 1e-5)
    w = torch.randn(ctx.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(7)).to(dtype)
    before = _tc_counts()
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    out = cat.chunk_train_attention(*leaves, args[5], seed, **kw)
    got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert _tc_counts() == (before[0] + 1, before[1] + 1, before[2], before[3])
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    ref = cat.forward_plain(*leaves, args[5], seed, c, L, R, drop)[0]
    want = torch.autograd.grad((ref.float() * w.float()).sum(), leaves)
    for name, a, e in zip(("q", "kv", "p", "u", "v"), got, want):
        assert bool(torch.isfinite(a).all()), name
        if bf16:
            rel = float((a.float() - e.float()).norm() / e.float().norm())
            assert rel <= 1e-2, (name, rel)
        else:
            torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-5, msg=name)


def _tc_counts():
    f = cat.chunk_train_attention
    return (f.fwd_launches, f.bwd_launches, f.fwd_tc_launches, f.bwd_tc_launches)


# (B, n, c, L, R, dk, p, lens): the flagship train shape (32 utterances of
# 199 subsampled frames) at p = 0 and 0.1; dk = 128; c = 128; (L, R) of
# (64, 0) and (0, 64); ragged lens (full length, below L, below one chunk);
# a length of 1
TC_CASES = [
    (32, 4, 64, 128, 128, 64, 0.0, [199] * 32),
    (32, 4, 64, 128, 128, 64, 0.1, [199] * 32),
    (4, 4, 64, 128, 128, 128, 0.0, [256, 199, 100, 37]),
    (3, 3, 128, 128, 128, 64, 0.1, [384, 300, 90]),
    (4, 4, 64, 64, 0, 64, 0.0, [256, 190, 70, 13]),
    (4, 4, 64, 0, 64, 64, 0.1, [256, 190, 70, 13]),
    (5, 4, 64, 128, 128, 64, 0.1, [256, 100, 40, 199, 130]),
    (3, 2, 64, 128, 128, 64, 0.0, [1, 128, 65]),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c,L,R,d_k,drop,lens", TC_CASES)
def test_train_attention_tensor_core_matches_plain(cuda_device, b, n, c, L, R, d_k, drop,
                                                   lens, dtype):
    """The tensor-core route against the plain forward and autograd through
    it, on the same inputs and dropout masks, at the bars of the CUDA-core
    route's cases of the dtype. bf16: ctx atol 1e-2 plus one bf16 ulp
    relative, m and den rtol 1e-2, every gradient within 1e-2 relative L2
    (the kernels round the weights, dS and its band to bf16 for the tensor
    cores and sum in f32). f32 (3xTF32 split products): ctx atol 1e-5, m and
    den rtol 1e-5, every gradient atol 1e-4 rtol 1e-5. Only the tensor-core
    counters move."""
    bf16 = dtype == torch.bfloat16
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device,
                                 seed=b + c + d_k, lens=lens)
    assert cat.route(*args[:3], c) == "tensor_core"
    kw = dict(chunk=c, left=L, right=R, drop_rate=drop)
    seed = 4321
    before = _tc_counts()
    ctx, m, den = cat.forward_kernel(*args, seed, c, L, R, drop, path="tensor_core")
    torch.cuda.synchronize()
    want_ctx, want_m, want_den = cat.forward_plain(*args, seed, c, L, R, drop)
    torch.testing.assert_close(ctx.float(), want_ctx.float(), atol=1e-2 if bf16 else 1e-5,
                               rtol=2.0 ** -7 if bf16 else 0.0)
    torch.testing.assert_close(m, want_m, atol=0.0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(den, want_den, atol=0.0, rtol=1e-2 if bf16 else 1e-5)

    w = torch.randn(ctx.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(5)).to(dtype)
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    out = cat.chunk_train_attention(*leaves, args[5], seed, **kw)
    got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    after = _tc_counts()
    assert after == (before[0], before[1], before[2] + 2, before[3] + 1)
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    ref = cat.forward_plain(*leaves, args[5], seed, c, L, R, drop)[0]
    want = torch.autograd.grad((ref.float() * w.float()).sum(), leaves)
    for name, a, e in zip(("q", "kv", "p", "u", "v"), got, want):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        assert bool(torch.isfinite(a).all()), name
        if bf16:
            rel = float((a.float() - e.float()).norm() / e.float().norm())
            assert rel <= 1e-2, (name, rel)
        else:
            torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-5, msg=name)
    # the stream's pad rows and the frames past each length get no gradient
    assert not bool(got[1][:, :L].any()) and not bool(got[1][:, L + n * c:].any())
    for i, ln in enumerate(lens):
        assert not bool(got[1][i, L + ln:L + n * c].any())
        assert not bool(got[0][i, ln:].any())


def _head_slice(args, h0, h1):
    """The operands of heads [h0, h1), contiguous, as a tensor-parallel rank holds them."""
    q, kv, p, u, v, lens = args
    return [t[..., h0:h1, :].contiguous() for t in (q, kv, p)] + [
        u[h0:h1].contiguous(), v[h0:h1].contiguous(), lens]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path,c,d_k", [("tensor_core", 64, 64), ("cuda_core", 64, 64),
                                        ("cuda_core", 8, 32)])
def test_train_attention_on_local_heads_equals_the_slice(cuda_device, path, c, d_k, dtype):
    """B4 and B5 on heads 4-7 of 8 alone, with head_offset 4 and
    heads_total 8, at dropout 0.1: every output equals, bit for bit, heads
    4-7 of the call on all 8 (a head's arithmetic never reads another's,
    and the dropout hash sees the global head)."""
    b, n, L, R, drop, seed = 3, 3, 16, 8, 0.1, 77
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device, seed=c + d_k)
    st = (seed, c, L, R, drop)
    ctx, m, den = cat.forward_kernel(*args, *st, path=path)
    dctx = torch.randn(ctx.shape, generator=torch.Generator(device=cuda_device).manual_seed(9),
                       device=cuda_device).to(dtype)
    full = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path=path)
    loc = _head_slice(args, 4, 8)
    lctx, lm, lden = cat.forward_kernel(*loc, *st, path=path, head_offset=4, heads_total=8)
    part = cat.backward_kernel(*loc, lctx, lm, lden, dctx[:, :, 4:8].contiguous(), *st,
                               path=path, head_offset=4, heads_total=8)
    torch.cuda.synchronize()
    assert torch.equal(lctx, ctx[:, :, 4:8])
    assert torch.equal(lm, m[:, 4:8]) and torch.equal(lden, den[:, 4:8])
    for name, a, e in zip(("dq", "dkv", "dp", "du", "dv"), part, full):
        assert torch.equal(a, e[..., 4:8, :]), name
    # without the offset the local call draws another mask
    other = cat.forward_kernel(*loc, *st, path=path)[0]
    assert not torch.equal(other, lctx)


@pytest.mark.parametrize("route", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("heads", [4, 8])
def test_train_attention_bf16_flat_attention(cuda_device, heads, route):
    """C13 (tensor cores) and C14 (CUDA cores): bf16 B5 where attention is
    flat (q, k, p, u, v of norm 0.05 a component) over values with a large
    common offset (4 a component, spread 0.2), the case where delta taken
    from the bf16 ctx, rowsum(dctx * ctx), missed by 0.03 relative L2 (CPU
    emulation): every gradient within 1e-2 relative L2 of autograd through
    the plain forward, which takes delta = rowsum(dA * A) in f32."""
    b, n, c, L, R, d_k = 3, 3, 64, 64, 64, 64
    g = torch.Generator(device="cpu").manual_seed(heads)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    tp = n * c
    kv = rnd(b, L + tp + R, heads, 2 * d_k)
    kv[..., :d_k] *= 0.05
    kv[..., d_k:] = kv[..., d_k:] * 0.2 + 4.0 * rnd(1, 1, heads, d_k)
    kv[:, :L] = 0
    kv[:, L + tp:] = 0
    small = [rnd(b, tp, heads, d_k) * 0.05, kv, rnd(2 * c - 1 + L + R, heads, d_k) * 0.05,
             rnd(heads, d_k) * 0.05, rnd(heads, d_k) * 0.05]
    args = [a.to(device=cuda_device, dtype=torch.bfloat16) for a in small]
    args.append(torch.tensor([tp, tp - 50, 70], dtype=torch.int32, device=cuda_device))
    assert cat.route(*args[:3], c) == "tensor_core"
    w = torch.randn((b, tp, heads, d_k), generator=g).to(device=cuda_device,
                                                         dtype=torch.bfloat16)
    before = _tc_counts()
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    entry = (cat.chunk_train_attention if route == "tensor_core"
             else cat.chunk_train_attention_cuda_core)
    out = entry(*leaves, args[5], 0, chunk=c, left=L, right=R)
    got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    tc = route == "tensor_core"
    assert _tc_counts() == (before[0] + (not tc), before[1] + (not tc), before[2] + tc,
                            before[3] + tc)
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    ref = cat.forward_plain(*leaves, args[5], 0, c, L, R, 0.0)[0]
    want = torch.autograd.grad((ref.float() * w.float()).sum(), leaves)
    rels = {name: float((a.float() - e.float()).norm() / e.float().norm())
            for name, a, e in zip(("q", "kv", "p", "u", "v"), got, want)}
    print("flat attention relative L2", route, heads, rels)
    assert max(rels.values()) <= 1e-2, rels


@pytest.mark.parametrize("dtype,d_k", [(torch.bfloat16, 64), (torch.float32, 64),
                                       (torch.float32, 128)])
def test_train_attention_tensor_core_backward_is_deterministic(cuda_device, dtype, d_k):
    """Two runs of the tensor-core backward on the same inputs give bitwise
    equal gradients (every cross-block sum has one owner and a fixed order)."""
    b, n, c, L, R, drop = 32, 4, 64, 128, 128, 0.1
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device, seed=9,
                                 lens=[199] * 31 + [77])
    st = (77, c, L, R, drop)
    ctx, m, den = cat.forward_kernel(*args, *st, path="tensor_core")
    dctx = torch.randn(ctx.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(6)).to(dtype)
    before = _tc_counts()
    first = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path="tensor_core")
    second = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path="tensor_core")
    torch.cuda.synchronize()
    assert _tc_counts() == (before[0], before[1], before[2], before[3] + 2)
    for name, a, e in zip(("dq", "dkv", "dp", "du", "dv"), first, second):
        assert torch.equal(a, e), name



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tensor_core_kernel_at_c256(cuda_device, dtype):
    """B1 on the tensor cores at c = 256, L = R = 256 (the example configs
    train with c, L, R in {64, 128, 256}) against the plain version."""
    args = _attention_args(5, 256, 256, 256, 4, 64, dtype, cuda_device, seed=256)
    assert route(*args[:3]) == "tensor_core"
    kw = dict(chunk=256, left=256, right=256)
    got = chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), chunk_attention_plain(*args, **kw).float(),
                               atol=1e-2 if bf16 else 1e-5, rtol=2.0 ** -7 if bf16 else 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_tensor_core_at_c256(cuda_device, dtype):
    """B4 and B5 on the tensor cores at c = 256, L = R = 256, head_dim 64
    (the example configs' 256 d over 4 heads), ragged lens, dropout 0.1."""
    b, n, c, L, R, d_k, drop = 3, 3, 256, 256, 256, 64, 0.1
    bf16 = dtype == torch.bfloat16
    args = _train_attention_args(b, n, c, L, R, 4, d_k, dtype, cuda_device, seed=257,
                                 lens=[768, 500, 190])
    assert cat.route(*args[:3], c) == "tensor_core"
    kw = dict(chunk=c, left=L, right=R, drop_rate=drop)
    seed = 11
    w = torch.randn((b, n * c, 4, d_k), device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(8)).to(dtype)
    before = _tc_counts()
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    out = cat.chunk_train_attention(*leaves, args[5], seed, **kw)
    got = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert _tc_counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    ref = cat.forward_plain(*leaves, args[5], seed, c, L, R, drop)[0]
    want = torch.autograd.grad((ref.float() * w.float()).sum(), leaves)
    torch.testing.assert_close(out.detach().float(), ref.detach().float(),
                               atol=1e-2 if bf16 else 1e-5, rtol=2.0 ** -7 if bf16 else 0.0)
    for name, a, e in zip(("q", "kv", "p", "u", "v"), got, want):
        if bf16:
            rel = float((a.float() - e.float()).norm() / e.float().norm())
            assert rel <= 1e-2, (name, rel)
        else:
            torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_eval_forward_on_ragged_batch(cuda_device, dtype):
    """B4 in eval (``encode``): under inference_mode the forward kernel
    launches alone, saves nothing for a backward and allocates no backward
    scratch, on a padded batch whose lens run from 1 frame to T (the
    tensor-core route's masking of whole invalid key tiles); against the
    plain forward."""
    b, n, c, L, R, d_k = 6, 4, 64, 128, 128, 64
    lens = [1, 17, 64, 65, 190, 256]
    args = _train_attention_args(b, n, c, L, R, 8, d_k, dtype, cuda_device, seed=3,
                                 lens=lens)
    kw = dict(chunk=c, left=L, right=R)
    saved = []
    before = _tc_counts()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        got = cat.chunk_train_attention(*args, **kw)
    torch.cuda.synchronize()
    assert _tc_counts() == (before[0], before[1], before[2] + 1, before[3])
    assert not saved and got.grad_fn is None
    # the call allocates ctx, m and den and nothing else (the caching
    # allocator may hand ctx a block up to 1 MiB larger); the backward's f32
    # partials alone would take more than the 2 MiB allowed
    returned = got.numel() * got.element_size() + 2 * b * 8 * n * c * 4
    scratch = sum(4 * math.prod(shape) for shape, _ in cat.partial_shapes(
        "tensor_core", b, n, 8, c, 2 * c - 1 + L + R, d_k))
    assert scratch > 2 * 2 ** 20
    assert torch.cuda.max_memory_allocated() - mem0 < returned + 2 * 2 ** 20
    want = cat.forward_plain(*args, 0, c, L, R, 0.0)[0]
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2 if bf16 else 1e-5,
                               rtol=2.0 ** -7 if bf16 else 0.0)
    for i, ln in enumerate(lens):
        assert not bool(got[i, ln:].any())


def test_attention_beam_search_device_on_the_card_equals_cpu(cuda_device):
    """``attention_beam_search_device`` on the card against the same search
    on the CPU (a tiny random hybrid model, f32, beam 4, ragged memory):
    identical tokens, scores within rtol 1e-5 (f32 summation order)."""
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.decode.search import attention_beam_search_device
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_

    cfg = ChunkFormerConfig.from_dict({
        "encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                         "num_blocks": 1},
        "decoder": "bitransformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 2,
                         "r_num_blocks": 1},
        "output_dim": 50})
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(4)).eval()
    g = torch.Generator().manual_seed(5)
    mem = torch.randn(3, 14, 64, generator=g)
    mask = torch.arange(14)[None, :] < torch.tensor([14, 9, 5])[:, None]
    want = attention_beam_search_device(model, cfg, mem, mask, 4)
    got = attention_beam_search_device(model.to(cuda_device), cfg, mem.to(cuda_device),
                                       mask.to(cuda_device), 4)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert any(r.tokens for r in want)
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], rtol=1e-5)
