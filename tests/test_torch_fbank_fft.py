"""The FFT fbank kernel's arithmetic (``csrc/fbank_fft.cu``), emulated step
for step in float32 numpy, against the port's plain version and the JAX
package's Pallas kernel; its tables, its tile walk and its route.

The emulation follows the kernel: frames of the waveform, the warp-sum mean,
preemphasis and window, the even/odd packing z[n] = x[2n] + i x[2n+1] of the
zero-padded frame, the radix-8 first stage and the radix-8/4 Stockham stages
in the kernel's order with the twiddle table the wrapper uploads, the real
split with the second table, all in float64; the power of bins k < padded / 2
rounded to float32, the sparse band table summed in ascending bin order, and
the log. A window padded to 64 or 128 points runs the 256-point plan and its
strided lane table; 4096 points run the in-place decimation-in-frequency
plan (``_dif``) and the real split reads each Z[k] at its digit-reversed
point. Above 4096 points the block plan (``csrc/fbank_fft_block.cu``, a
block of 256 threads a frame) is emulated by ``fbank_block_emulated``: the
block's frame mean, the same in-place plan at ``fft_block_radices``, the
split of each pair (k, N - k), and float64 mel sums, a band a warp.

The module's torch work runs on one thread, as the tile-walk files do: six
test workers then do not oversubscribe the cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.ops.fbank import fbank as jax_fbank
from chunkformer_tpu.ops.pallas.fbank import fbank_pallas
from chunkformer_tpu_torch.ops import fbank as fb

F32, F64 = np.float32, np.float64
SQRT_HALF = np.sqrt(0.5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cmul(a, w):
    return np.stack([a[..., 0] * w[..., 0] - a[..., 1] * w[..., 1],
                     a[..., 0] * w[..., 1] + a[..., 1] * w[..., 0]], -1)


def _mul_neg_i(a):
    return np.stack([a[..., 1], -a[..., 0]], -1)


def _dft4(a):
    b0, b2 = a[0] + a[2], a[0] - a[2]
    b1, b3 = a[1] + a[3], _mul_neg_i(a[1] - a[3])
    return [b0 + b1, b2 + b3, b0 - b1, b2 - b3]


def _dft2(a):
    return [a[0] + a[1], a[0] - a[1]]


def _dft8(a):
    e = [a[j] + a[j + 4] for j in range(4)]
    o = [a[j] - a[j + 4] for j in range(4)]
    o[1] = np.stack([(o[1][..., 0] + o[1][..., 1]) * SQRT_HALF,
                     (o[1][..., 1] - o[1][..., 0]) * SQRT_HALF], -1)
    o[2] = _mul_neg_i(o[2])
    o[3] = np.stack([(o[3][..., 1] - o[3][..., 0]) * SQRT_HALF,
                     -(o[3][..., 0] + o[3][..., 1]) * SQRT_HALF], -1)
    e, o = _dft4(e), _dft4(o)
    return [x for q in range(4) for x in (e[q], o[q])]


def _stage(z, radix, p, twiddle):
    """One Stockham stage: butterfly i < N / radix takes z[i + j N/radix],
    twiddles them by the stage's twiddle[(j - 1) p + i mod p] (none in the
    first stage, p = 1), and writes its DFT to z[(i / p) p radix + i mod p +
    j p]."""
    n = z.shape[1]
    t = n // radix
    i = np.arange(t)
    k = i % p
    a = [z[:, i + j * t] for j in range(radix)]
    for j in range(1, radix if twiddle is not None else 1):
        a[j] = _cmul(a[j], twiddle[(j - 1) * p + k][None])
    x = _dft8(a) if radix == 8 else _dft4(a)
    out = np.empty_like(z)
    base = (i // p) * p * radix + k
    for j in range(radix):
        out[:, base + j * p] = x[j]
    return out


def _twiddle_of(split, e):
    """W_N^e from the split table W_2N^k, k < N (``twiddle_of`` in the
    kernel): split[2e], or -split[2e - N] past the table."""
    n = split.shape[0]
    k = 2 * e
    return np.where((k < n)[:, None], split[np.minimum(k, n - 1)],
                    -split[np.maximum(k - n, 0)])


def _dif(z, radices, split):
    """The 4096-point plan's stages (``first_butterfly`` at N = 2048, then
    ``dif_stage``): radix R over blocks of Ls points, butterfly u taking
    z[base + j h], h = Ls / R, base = (u / h) Ls + u mod h, and writing
    output q times W_Ls^{(u mod h) q} back to z[base + q h]."""
    n = z.shape[1]
    ls = n
    for radix in radices:
        h = ls // radix
        u = np.arange(n // radix)
        i, base = u % h, (u // h) * ls + u % h
        x = [z[:, base + j * h] for j in range(radix)]
        x = {8: _dft8, 4: _dft4, 2: _dft2}[radix](x)
        out = np.empty_like(z)
        for q in range(radix):
            w = x[q]
            if h > 1 and q > 0:
                w = _cmul(w, _twiddle_of(split, i * q * (n // ls))[None])
            out[:, base + q * h] = w
        z, ls = out, h
    return z


def dif_positions(radices):
    """Where the in-place plan leaves Z[k]: the digits of k (radix r1 first)
    weight N / r1, N / (r1 r2), ..."""
    n = int(np.prod(radices))
    k, pos, span = np.arange(n), np.zeros(n, np.int64), n
    for radix in radices:
        span //= radix
        pos += (k % radix) * span
        k = k // radix
    return pos


def fbank_emulated(wave, num_mel_bins=80, frame_length=25.0, frame_shift=10.0,
                   sample_rate=16000):
    """The FFT kernel's arithmetic in numpy: float64 from the float32
    samples, window and twiddle tables up to the power spectrum, then the
    float32 sparse mel product and log: [S] -> [T, num_mel_bins] float32."""
    win, shift, padded = fb._geometry(sample_rate, frame_length, frame_shift)
    n = fb.num_frames(wave.shape[0], sample_rate, frame_length, frame_shift)
    if n == 0:
        return np.zeros((0, num_mel_bins), F32)
    lanes = fb.mel_lanes(num_mel_bins, padded, float(sample_rate))
    padded = fb.fft_points(padded)                       # the plan the kernel runs
    half = padded // 2
    twiddle, split = fb.fft_twiddles(padded)
    x = wave.astype(F32)[np.arange(n)[:, None] * shift + np.arange(win)[None]].astype(F64)
    mean = x.sum(1) * (1.0 / win)
    xm = x - mean[:, None]
    prev = np.concatenate([xm[:, :1], xm[:, :-1]], 1)
    frames = np.zeros((n, padded), F64)
    frames[:, :win] = (xm - F64(F32(0.97)) * prev) * fb.povey_window(win).astype(F64)
    z = frames.reshape(n, half, 2)                       # z[m] = x[2m] + i x[2m+1]
    if padded in fb.FFT_DIF_RADICES:
        radices = fb.FFT_DIF_RADICES[padded]
        z = _dif(z, radices, split)
        pos = dif_positions(radices)
    else:
        z = _stage(z, 8, 1, None)                        # the first stage, in registers
        for radix, p in fb.FFT_STAGES[padded]:
            z = _stage(z, radix, p, twiddle)
            twiddle = twiddle[(radix - 1) * p:]
        pos = np.arange(half)
    k = np.arange(half)
    zk, zm = z[:, pos[k]], z[:, pos[(half - k) % half]]
    u = _cmul(np.stack([zk[..., 0] - zm[..., 0], zk[..., 1] + zm[..., 1]], -1), split[None])
    re = 0.5 * (zk[..., 0] + zm[..., 0] + u[..., 1])
    im = 0.5 * (zk[..., 1] - zm[..., 1] - u[..., 0])
    power = (re * re + im * im).astype(F32)
    mel = np.zeros((n, num_mel_bins), F32)
    acc = np.zeros((n, lanes.shape[1]), F32)
    for step in lanes:                                   # all lanes take a step together
        bins, ends = step[:, 0] & 0xFFFF, step[:, 0].view(np.uint32) >> 16
        acc += power[:, bins] * step[:, 1].view(F32)
        for lane in np.flatnonzero(ends):
            mel[:, ends[lane] - 1] = acc[:, lane]
            acc[:, lane] = 0
    return np.log(np.maximum(mel, F32(fb._EPSILON)))


@pytest.mark.parametrize("sample_rate", [16000, 8000])
@pytest.mark.parametrize("n_samples", [100, 400, 16123, 192000])
def test_emulated_kernel_matches_plain_and_pallas(n_samples, sample_rate):
    """atol 2e-3 / rtol 1e-3, the JAX package's bar for its kernel
    (tests/test_fbank.py): float32 FFT against float32 FFT and DFT orders of
    int16-scale audio before a log."""
    wave = (np.random.default_rng(7).normal(size=n_samples) * 8000).astype(F32)
    got = fbank_emulated(wave, sample_rate=sample_rate)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), sample_rate=sample_rate).numpy(),
             "pallas": np.asarray(fbank_pallas(jnp.asarray(wave), sample_rate=sample_rate,
                                               interpret=True))}
    for name, want in wants.items():
        assert got.shape == want.shape == (fb.num_frames(n_samples, sample_rate), 80), name
        err = np.abs(got - want)
        print(f"{name}: {got.shape[0]} frames, max |emulated - {name}| "
              f"{err.max() if err.size else 0.0:.3g}")
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("frame_length,sample_rate", [(50.0, 16000), (25.0, 22050)])
@pytest.mark.parametrize("n_samples", [900, 16123, 48000])
def test_emulated_kernel_matches_plain_and_pallas_at_1024_points(n_samples, frame_length,
                                                                 sample_rate):
    """A padded window of 1024 points (50 ms at 16 kHz, 25 ms at 22.05 kHz):
    two first-stage butterflies a lane, then the radix-8 stages (8, 8) and
    (8, 64); the same bar against the plain version and the Pallas kernel."""
    assert fb._geometry(sample_rate, frame_length, 10.0)[2] == 1024
    wave = (np.random.default_rng(11).normal(size=n_samples) * 8000).astype(F32)
    kw = dict(frame_length=frame_length, sample_rate=sample_rate)
    got = fbank_emulated(wave, **kw)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), **kw).numpy(),
             "pallas": np.asarray(fbank_pallas(jnp.asarray(wave), interpret=True, **kw))}
    for name, want in wants.items():
        assert got.shape == want.shape == (fb.num_frames(n_samples, sample_rate,
                                                         frame_length), 80), name
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("kwargs", [
    dict(frame_length=50.0, frame_shift=10.0625),        # padded 1024, shift 161
    dict(frame_shift=10.0625),                           # padded 512, shift 161
    dict(frame_shift=40.0),                              # shift 640 > padded 512
    dict(sample_rate=44100),                             # 1102 samples, padded 2048
    dict(sample_rate=48000, frame_length=42.6, num_mel_bins=128),  # 2044 of 2048
    dict(sample_rate=44100, frame_shift=10.0),           # 2048 points, shift 441 (odd)
])
@pytest.mark.parametrize("seconds", [0.3, 1.1])
def test_emulated_kernel_matches_plain_and_pallas_at_new_geometries(kwargs, seconds):
    """The geometries the FFT kernel took from the DFT kernel: odd shifts
    (frames at odd samples), a shift longer than the padded window, and
    2048-point windows (four first-stage butterflies a lane, then the
    stages (8, 8), (4, 64), (4, 256)); the same bar against the plain
    version and the Pallas kernel."""
    sample_rate = kwargs.get("sample_rate", 16000)
    n_samples = int(seconds * sample_rate) + 37
    wave = (np.random.default_rng(13).normal(size=n_samples) * 8000).astype(F32)
    assert fb.route(**kwargs) == "fft"
    got = fbank_emulated(wave, **kwargs)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), **kwargs).numpy(),
             "pallas": np.asarray(fbank_pallas(jnp.asarray(wave), interpret=True, **kwargs))}
    n = fb.num_frames(n_samples, sample_rate, kwargs.get("frame_length", 25.0),
                      kwargs.get("frame_shift", 10.0))
    for name, want in wants.items():
        assert got.shape == want.shape == (n, kwargs.get("num_mel_bins", 80)), name
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("kwargs", [
    dict(frame_length=15.0, sample_rate=8000),           # 120 samples, padded 128
    dict(frame_length=8.0, sample_rate=8000),            # 64 samples, padded 64
    dict(frame_length=4.0, frame_shift=2.5625),          # 64 samples, padded 64, shift 41
    dict(sample_rate=96000),                             # 2400 samples, padded 4096
    dict(sample_rate=48000, frame_length=50.0, frame_shift=25.0),   # 2400 of 4096
    dict(sample_rate=96000, frame_length=42.6, frame_shift=10.0625),  # 4089 of 4096, odd
    dict(num_mel_bins=160),                              # 160 bins at 512 points
    dict(sample_rate=44100, num_mel_bins=160),           # 160 bins at 2048 points
])
def test_emulated_kernel_matches_plain_and_pallas_at_every_geometry(kwargs):
    """The geometries the FFT kernel took from the DFT kernel in the last
    step (C22, C23): windows padded to 64 and 128 points through the
    256-point plan and its strided lane table, 4096-point windows through
    the in-place plan, and more than 128 mel bins; against the plain
    version and the Pallas kernel at atol 2e-3 + rtol 1e-3."""
    sample_rate = kwargs.get("sample_rate", 16000)
    fl, fs = kwargs.get("frame_length", 25.0), kwargs.get("frame_shift", 10.0)
    win, shift, padded = fb._geometry(sample_rate, fl, fs)
    n_samples = 9 * shift + win + 5
    wave = (np.random.default_rng(17).normal(size=n_samples) * 8000).astype(F32)
    assert fb.route(**kwargs) == "fft"
    got = fbank_emulated(wave, **kwargs)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), **kwargs).numpy(),
             "pallas": np.asarray(fbank_pallas(jnp.asarray(wave), interpret=True, **kwargs))}
    for name, want in wants.items():
        assert got.shape == want.shape == (10, kwargs.get("num_mel_bins", 80)), name
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


def tile_walk(wave_offset, n_frames, win, shift, tile_frames):
    """The FFT kernel's copies of each tile into shared memory (``copy_tile``,
    ``frame_in_tile``, ``tile_span`` in ``csrc/fbank_fft.cu``), emulated on
    sample indices: a waveform starting ``wave_offset`` floats past a
    16-byte boundary; yields (frame, the frame's samples as indices into the
    waveform, or -1 for a zero-filled float, the frame's offset in the
    buffer and the buffer span)."""
    span = fb.fft_tile_span(win, shift, tile_frames)
    aligned = wave_offset == 0
    each = shift > win
    stride = (win + 3 + 3) & ~3 if each else 0
    for t0 in range(0, n_frames, tile_frames):
        nf = min(tile_frames, n_frames - t0)
        buf = np.full(span + 1, -2, np.int64)          # -2: never written
        runs, length = (nf, win) if each else (1, (nf - 1) * shift + win)
        for r in range(runs):
            g = (t0 + r) * shift
            if aligned:
                ld = g & 3
                for k in range((length + 6) // 4):
                    need = ld + length - 4 * k
                    if need > 0:                         # 16 bytes, zero past `need` floats
                        assert r * stride + 4 * k + 4 <= span
                        for e in range(4):
                            buf[r * stride + 4 * k + e] = g - ld + 4 * k + e if e < need else -1
            else:                                        # 4 bytes a thread
                assert r * stride + length <= span
                buf[r * stride:r * stride + length] = g + np.arange(length)
        for f in range(nf):
            g = (t0 + f) * shift
            if each:
                first = f * stride + (g & 3 if aligned else 0)
            else:
                first = (t0 * shift & 3 if aligned else 0) + f * shift
            yield t0 + f, buf[first:first + win], first, span


@pytest.mark.parametrize("sample_rate,frame_length,frame_shift", [
    (16000, 25.0, 10.0), (16000, 25.0, 10.0625), (16000, 50.0, 10.0625),
    (16000, 25.0, 40.0), (44100, 25.0, 10.0), (16000, 25.0, 25.0), (8000, 25.0, 10.0),
    (96000, 25.0, 10.0), (8000, 15.0, 10.0)])
@pytest.mark.parametrize("wave_offset", [0, 1, 3])
def test_tile_walk_stages_each_frame(sample_rate, frame_length, frame_shift, wave_offset):
    """Every frame the kernel reads from its tile buffer is the frame's own
    samples, wherever the tile starts (16-byte copies from the boundary
    below the first sample, or 4-byte copies of an unaligned waveform), at
    the tile size ``fft_tile_frames`` picks; no copy passes the buffer. At
    an even shift every frame starts at an even float (8-byte aligned),
    which the kernel's pair loads (its instance for even shifts) need."""
    win, shift, padded = fb._geometry(sample_rate, frame_length, frame_shift)
    steps = fb.mel_lanes(80, padded, float(sample_rate)).shape[0]
    tile_frames = fb.fft_tile_frames(padded, win, shift, 80, steps)
    n_frames = 2 * tile_frames + 3
    seen = []
    for f, samples, first, span in tile_walk(wave_offset, n_frames, win, shift, tile_frames):
        assert np.array_equal(samples, f * shift + np.arange(win)), f
        assert shift % 2 or first % 2 == 0, (f, first)
        seen.append(f)
    assert seen == list(range(n_frames))


@pytest.mark.parametrize("padded,win,shift,n_mels,sample_rate", [
    (512, 400, 160, 80, 16000), (1024, 1024, 1024, 128, 16000), (2048, 2048, 2047, 128, 96000),
    (2048, 1102, 441, 80, 44100), (2048, 1920, 960, 80, 96000), (2048, 2048, 1, 128, 48000),
    (256, 256, 100000, 128, 8000), (2048, 1025, 3000, 80, 22050),
    (4096, 2400, 960, 80, 96000), (4096, 2400, 1200, 160, 48000), (4096, 4096, 1, 128, 96000),
    (128, 120, 80, 80, 8000), (64, 64, 41, 23, 16000), (512, 400, 160, 160, 16000),
    (2048, 1102, 441, 160, 44100), (512, 400, 160, 1000, 16000)])
def test_fft_tile_frames_fit_the_block(padded, win, shift, n_mels, sample_rate):
    """Across the FFT route's domain (window up to the padded size, any
    shift, any bin count; 64 and 128 points on the 256-point plan, 4096
    points with two warps a block) a tile of at least as many frames as the
    block has warps fits the shared memory a block may take, and the 25 ms
    main path keeps its 16 frames at 75.8 KB (three blocks an SM)."""
    steps = fb.mel_lanes(n_mels, padded, float(sample_rate)).shape[0]
    frames = fb.fft_tile_frames(padded, win, shift, n_mels, steps)
    assert fb.fft_warps(padded) <= frames <= fb.FFT_MAX_TILE_FRAMES
    assert frames <= fb.fft_warps(padded) or frames % fb.fft_warps(padded) == 0
    assert fb.fft_smem_bytes(padded, win, shift, n_mels, steps, frames) <= fb.FFT_SMEM_BYTES
    if (padded, win, shift, n_mels) == (512, 400, 160, 80):
        assert frames == 16 and fb.fft_smem_bytes(padded, win, shift, n_mels, steps,
                                                  frames) == 75808


@pytest.mark.parametrize("num_bins,padded,sample_rate", [
    (80, 512, 16000), (80, 256, 8000), (40, 512, 16000), (128, 512, 16000),
    (80, 1024, 16000), (80, 2048, 44100), (128, 2048, 48000)])
def test_band_table_rebuilds_mel_banks(num_bins, padded, sample_rate):
    """Scattering the band table back gives ``mel_banks`` bit for bit, and no
    band reaches the Nyquist bin (which the kernel does not form)."""
    first, count, offset, weights = fb.band_table(num_bins, padded, float(sample_rate))
    want = fb.mel_banks(num_bins, padded, float(sample_rate))
    rebuilt = np.zeros_like(want)
    for m in range(num_bins):
        rebuilt[first[m]:first[m] + count[m], m] = weights[offset[m]:offset[m] + count[m]]
    assert np.array_equal(rebuilt.view(np.uint32), want.view(np.uint32))
    assert (first + count).max() <= padded // 2
    assert weights.size == int(count.sum()) < want.size // 4
    assert offset.dtype == first.dtype == count.dtype == np.int32


@pytest.mark.parametrize("num_bins,padded,sample_rate", [
    (80, 512, 16000), (80, 256, 8000), (40, 512, 16000), (128, 512, 16000),
    (80, 1024, 16000), (80, 1024, 22050), (80, 2048, 44100), (128, 2048, 96000),
    (80, 128, 8000), (23, 64, 16000), (160, 512, 16000), (160, 2048, 44100),
    (80, 4096, 96000)])
def test_mel_lanes_rebuild_mel_banks(num_bins, padded, sample_rate):
    """Every band ends once, in one lane, its bins ascending and contiguous
    (in steps of 256 / padded of the 256-point plan below 256 points);
    scattering the steps back gives ``mel_banks`` bit for bit; a lane's
    steps after its last band are (0, 0.0); the lanes take as few steps as
    the widest band and the mean share allow."""
    lanes = fb.mel_lanes(num_bins, padded, float(sample_rate))
    want = fb.mel_banks(num_bins, padded, float(sample_rate))
    count = fb.band_table(num_bins, padded, float(sample_rate))[1]
    stride = fb.fft_points(padded) // padded
    assert (lanes[..., 0] & 0xFFFF).max() < fb.fft_points(padded) // 2
    rebuilt = np.zeros_like(want)
    ended = []
    for lane in lanes.transpose(1, 0, 2):                # one lane's [steps, 2]
        start = 0
        for i, code in enumerate(lane[:, 0]):
            if code >> 16:
                m = (code >> 16) - 1
                bins, ws = lane[start:i + 1, 0] & 0xFFFF, lane[start:i + 1, 1].view(F32)
                assert not (bins % stride).any()
                bins = bins // stride
                if count[m]:
                    assert np.array_equal(bins, np.arange(bins[0], bins[0] + count[m]))
                    rebuilt[bins, m] = ws
                else:
                    assert ws.tolist() == [0.0]
                ended.append(m)
                start = i + 1
        assert not lane[start:].any()
    assert sorted(ended) == list(range(num_bins))
    assert np.array_equal(rebuilt.view(np.uint32), want.view(np.uint32))
    steps = np.maximum(count, 1)
    assert lanes.shape == (max(int(steps.max()), -(-int(steps.sum()) // 32)), 32, 2)


@pytest.mark.parametrize("padded", [256, 512, 1024, 2048])
def test_twiddle_tables(padded):
    """float64 stage tables, exp(-2 pi i k j / (P R)) at row (j - 1) P + k
    of each stage's block in ``FFT_STAGES`` order, and the split's
    exp(-2 pi i k / padded); the stages combine all padded / 2 points."""
    stages, split = fb.fft_twiddles(padded)
    assert stages.dtype == split.dtype == np.float64
    row = 0
    for radix, p in fb.FFT_STAGES[padded]:
        for j in range(1, radix):
            want = np.exp(-2j * np.pi * np.arange(p) * j / (p * radix))
            np.testing.assert_allclose(stages[row:row + p, 0] + 1j * stages[row:row + p, 1],
                                       want, rtol=0, atol=1e-15)
            row += p
    assert row == stages.shape[0] and 8 * np.prod([r for r, _ in fb.FFT_STAGES[padded]]) \
        == padded // 2
    k = np.arange(padded // 2)
    assert np.array_equal(split[:, 0] + 1j * split[:, 1], np.exp(-2j * np.pi * k / padded))


def test_twiddles_and_order_of_the_4096_point_plan():
    """The in-place plan has no stage table: W_2048^e, e < 2048, read from
    the split table as the kernel's ``twiddle_of`` reads it, is the direct
    value to 1e-15; its radices combine 2048 points; it leaves Z[k] at the
    kernel's ``z_pos``, 256 q1 + 32 q2 + 4 q3 + q4; and the emulated plan is
    numpy's FFT of the same points."""
    stages, split = fb.fft_twiddles(4096)
    assert stages.shape == (0, 2) and split.shape == (2048, 2)
    e = np.arange(2048)
    w = _twiddle_of(split, e)
    np.testing.assert_allclose(w[:, 0] + 1j * w[:, 1], np.exp(-2j * np.pi * e / 2048), rtol=0,
                               atol=1e-15)
    radices = fb.FFT_DIF_RADICES[4096]
    assert np.prod(radices) == 2048
    k = np.arange(2048)
    assert np.array_equal(dif_positions(radices), 256 * (k & 7) + 32 * ((k >> 3) & 7)
                          + 4 * ((k >> 6) & 7) + (k >> 9))
    z = np.random.default_rng(3).normal(size=(2, 2048, 2))
    got = _dif(z, radices, split)[:, dif_positions(radices)]
    want = np.fft.fft(z[..., 0] + 1j * z[..., 1], axis=1)
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], want, rtol=0, atol=1e-9)


THREADS = fb.FFT_BLOCK_THREADS


def _xor_tree(lanes):
    """A warp's shuffle sum (``__shfl_xor_sync`` at 16, 8, 4, 2, 1) over the
    last axis of 32 lanes; lane 0's total."""
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def _strided_sums(vals, lanes):
    """Each of ``lanes`` threads' sum of vals[..., lane + lanes t], t in
    order: [..., lanes]."""
    width = -(-vals.shape[-1] // lanes) * lanes
    padded = np.zeros(vals.shape[:-1] + (width,), F64)
    padded[..., :vals.shape[-1]] = vals
    acc = np.zeros(vals.shape[:-1] + (lanes,), F64)
    for t in range(width // lanes):
        acc += padded[..., t * lanes:(t + 1) * lanes]
    return acc


def fbank_block_emulated(wave, num_mel_bins=80, frame_length=25.0, frame_shift=10.0,
                         sample_rate=16000):
    """The block plan's arithmetic in numpy, float64 from the float32 samples
    and window to the log: the frame mean as the block sums it (each of 256
    threads over its strided samples, each warp's shuffle tree, the 8 warp
    sums in order), preemphasis and window, the in-place plan of radices
    ``fft_block_radices`` with the split table's twiddles (the first stage
    from the samples), the split of each pair (k, N - k) at the points
    ``dif_positions`` gives, and each band summed by a warp (lane l takes its
    bins l, l + 32, ..., then the shuffle tree); the log rounded to
    float32."""
    win, shift, padded = fb._geometry(sample_rate, frame_length, frame_shift)
    n = fb.num_frames(wave.shape[0], sample_rate, frame_length, frame_shift)
    if n == 0:
        return np.zeros((0, num_mel_bins), F32)
    half = padded // 2
    split = fb.fft_twiddles(padded)[1]
    x = wave.astype(F32)[np.arange(n)[:, None] * shift + np.arange(win)[None]].astype(F64)
    warps = _xor_tree(_strided_sums(x, THREADS).reshape(n, THREADS // 32, 32))
    total = np.zeros(n, F64)
    for w in range(THREADS // 32):
        total += warps[:, w]
    mean = total * (1.0 / win)
    xm = x - mean[:, None]
    prev = np.concatenate([xm[:, :1], xm[:, :-1]], 1)
    frames = np.zeros((n, padded), F64)
    frames[:, :win] = (xm - F64(F32(0.97)) * prev) * fb.povey_window(win).astype(F64)
    radices = fb.fft_block_radices(padded)
    z = _dif(frames.reshape(n, half, 2), radices, split)
    pos = dif_positions(radices)
    k = np.arange(half)
    zk, zm = z[:, pos[k]], z[:, pos[(half - k) % half]]
    u = _cmul(np.stack([zk[..., 0] - zm[..., 0], zk[..., 1] + zm[..., 1]], -1), split[None])
    re = 0.5 * (zk[..., 0] + zm[..., 0] + u[..., 1])
    im = 0.5 * (zk[..., 1] - zm[..., 1] - u[..., 0])
    power = re * re + im * im
    first, count, offset, weights = fb.band_table(num_mel_bins, padded, float(sample_rate))
    mel = np.zeros((n, num_mel_bins), F64)
    for m in range(num_mel_bins):
        w = weights[offset[m]:offset[m] + count[m]].astype(F64)
        mel[:, m] = _xor_tree(_strided_sums(power[:, first[m]:first[m] + count[m]] * w, 32))
    return np.log(np.maximum(mel, fb._EPSILON)).astype(F32)


def test_block_plan_matches_pallas_at_8192_points():
    """50 ms at 96 kHz (4800 samples, padded 8192) on 0.5 s of int16-scale
    noise: the block plan's emulation within atol 2e-3 + rtol 1e-3 of the
    JAX package's Pallas kernel in interpret mode (its [win, bins] DFT
    tables make this about 6 s on a CPU) and of the plain version."""
    kw = dict(sample_rate=96000, frame_length=50.0)
    assert fb._geometry(96000, 50.0, 10.0)[2] == 8192 and fb.route(**kw) == "fft"
    wave = (np.random.default_rng(19).normal(size=48000) * 8000).astype(F32)
    got = fbank_block_emulated(wave, **kw)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), **kw).numpy(),
             "pallas": np.asarray(fbank_pallas(jnp.asarray(wave), interpret=True, **kw))}
    for name, want in wants.items():
        assert got.shape == want.shape == (fb.num_frames(48000, 96000, 50.0), 80), name
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("kwargs", [
    dict(sample_rate=48000, frame_length=100.0),                      # 4800 of 8192
    dict(sample_rate=48000, frame_length=100.0, frame_shift=10.0625),  # shift 483 (odd)
    dict(sample_rate=48000, frame_length=100.0, frame_shift=120.0),   # shift 5760 > win
    dict(sample_rate=96000, frame_length=100.0),                      # 9600 of 16384
    dict(sample_rate=96000, frame_length=100.0, num_mel_bins=160),
    dict(sample_rate=192000, frame_length=100.0),                     # 19200 of 32768
])
def test_block_plan_matches_jax_fbank(kwargs):
    """8192, 16384 and 32768 points (odd and long shifts, 160 bins) on 0.5 s
    of noise: the emulation within the fbank bar of the JAX package's plain
    ``fbank`` (dither 0) and of the port's plain version. The Pallas kernel
    is left out here: in interpret mode its [win, bins] DFT tables take 23 s
    and more from 16384 points on a CPU."""
    sr = kwargs["sample_rate"]
    n_samples = sr // 2 + 37
    wave = (np.random.default_rng(23).normal(size=n_samples) * 8000).astype(F32)
    assert fb.route(**kwargs) == "fft"
    got = fbank_block_emulated(wave, **kwargs)
    wants = {"plain": fb.fbank_plain(torch.from_numpy(wave), **kwargs).numpy(),
             "jax": np.asarray(jax_fbank(jnp.asarray(wave), dither=0.0, **kwargs))}
    n = fb.num_frames(n_samples, sr, kwargs["frame_length"], kwargs.get("frame_shift", 10.0))
    for name, want in wants.items():
        assert got.shape == want.shape == (n, kwargs.get("num_mel_bins", 80)), name
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3, err_msg=name)


def block_slot(c, log_n):
    """``slot`` in ``csrc/fbank_fft_block.cu``: bits 3-5 and the top three
    bits of point c folded into its low three."""
    return c ^ (((c >> 3) ^ (c >> (log_n - 3))) & 7)


def block_z_pos(k, log_n):
    """``z_pos`` in ``csrc/fbank_fft_block.cu``."""
    pos, s = np.zeros_like(k), log_n
    while s >= 3:
        pos |= (k & 7) << (s - 3)
        k = k >> 3
        s -= 3
    return pos | k


@pytest.mark.parametrize("padded", [8192, 16384, 32768, 262144])
def test_block_plan_stages_positions_and_swizzle(padded):
    """The block plan's radices combine padded / 2 points, radix 8 first and
    one stage of 4 or 2 last; the emulated plan with the split table's
    twiddles is numpy's FFT; the kernel's ``z_pos`` is the plan's
    digit-reversed order; ``slot`` is a permutation, and every quarter-warp
    (8 consecutive threads) reaches 8 different 16-byte bank groups in each
    stage's loads and stores, the first stage's stores and the split's
    loads of Z[k]."""
    half = padded // 2
    log_n = half.bit_length() - 1
    radices = fb.fft_block_radices(padded)
    assert np.prod(radices) == half and set(radices[:-1]) <= {8} and radices[0] == 8
    assert fb.fft_block_radices(4096) == fb.FFT_DIF_RADICES[4096]
    split = fb.fft_twiddles(padded)[1]
    z = np.random.default_rng(5).normal(size=(1, half, 2))
    got = _dif(z, radices, split)[:, dif_positions(radices)]
    want = np.fft.fft(z[..., 0] + 1j * z[..., 1], axis=1)
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], want, rtol=0,
                               atol=1e-9 * np.sqrt(half))
    k = np.arange(half)
    assert np.array_equal(block_z_pos(k, log_n), dif_positions(radices))
    slots = block_slot(k, log_n)
    assert np.array_equal(np.sort(slots), k)

    def distinct(points):            # [threads, ...] points, one row a thread
        groups = block_slot(points, log_n).reshape(-1, 8, *points.shape[1:]) & 7
        return all(len(set(g)) == 8 for g in np.moveaxis(groups, 1, -1).reshape(-1, 8))

    t1 = half // 8
    u = np.arange(t1)
    assert distinct(u[:, None] + np.arange(8)[None] * t1)          # the first stage
    ls = t1
    for radix in radices[1:]:
        h = ls // radix
        u = np.arange(half // radix)
        base = (u - (u & (h - 1))) * radix + (u & (h - 1))
        assert distinct(base[:, None] + np.arange(radix)[None] * h), (radix, ls)
        ls = h
    assert distinct(block_z_pos(np.arange(half // 2 // 8 * 8), log_n))   # the split's Z[k]


@pytest.mark.parametrize("padded,in_shared", [(8192, True), (16384, True), (32768, False),
                                              (65536, False), (262144, False)])
def test_block_plan_sizing(padded, in_shared):
    """The frame's buffer (padded / 2 complex float64) and the warps' 64
    bytes of partial sums fit the 227 KB a block may take up to 16384 points
    (64 and 128 KB), two blocks an SM at 8192 points and one at 16384; from
    32768 points the wrapper allocates a workspace of one buffer a block,
    one block an SM: 256 KB a slot and 33.8 MB over an H100's 132 SMs at
    32768 points, within its 50 MB L2; never more blocks than frames."""
    assert fb.fft_block_in_shared(padded) == in_shared
    grid = fb.fft_block_grid(padded, 12000, 132)
    if in_shared:
        assert 8 * padded + 64 <= fb.FFT_SMEM_BYTES
        assert grid == {8192: 264, 16384: 132}[padded]
        assert grid // 132 * (8 * padded + 64 + fb.BLOCK_RESERVED_SMEM) <= fb.SM_SMEM_BYTES
        assert fb.fft_block_workspace_bytes(padded, grid) == 0
    else:
        assert grid == 132
        assert fb.fft_block_workspace_bytes(padded, grid) == 132 * padded // 2 * 16
    assert fb.fft_block_grid(padded, 3, 132) == 3
    assert fb.fft_block_workspace_bytes(32768, 132) == 34603008 < 50 * 2 ** 20


def test_block_plan_band_table_at_262144_points():
    """1 s windows at 192 kHz (192000 samples, padded 262144): the block
    plan's int32 band table (first bin, bins, first weight) holds bins past
    the warp plans' 16-bit field (65535) and rebuilds ``mel_banks`` bit for
    bit; no band reaches the Nyquist bin."""
    assert fb._geometry(192000, 1000.0, 10.0)[2] == 262144
    _, _, bands, weights = fb._fft_block_tables(192000, 262144, 80, 192000,
                                                torch.device("cpu"))
    bands, weights = bands.numpy(), weights.numpy()
    assert bands.dtype == np.int32 and bands.shape == (80, 4) and not bands[:, 3].any()
    first, count, offset = bands[:, 0], bands[:, 1], bands[:, 2]
    assert int((first + count).max()) > 0xFFFF and int((first + count).max()) <= 131072
    want = fb.mel_banks(80, 262144, 192000.0)
    rebuilt = np.zeros_like(want)
    for m in range(80):
        rebuilt[first[m]:first[m] + count[m], m] = weights[offset[m]:offset[m] + count[m]]
    assert np.array_equal(rebuilt.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kwargs,want", [
    ({}, "fft"),
    ({"sample_rate": 8000}, "fft"),
    ({"num_mel_bins": 40}, "fft"),
    ({"frame_length": 32.0}, "fft"),                    # 512 samples, no padding
    ({"frame_length": 50.0}, "fft"),                    # padded 1024
    ({"frame_length": 10.0}, "fft"),                    # 160 samples padded to 256
    ({"sample_rate": 22050}, "fft"),                    # padded 1024
    ({"frame_length": 50.0, "frame_shift": 10.0625}, "fft"),  # padded 1024, odd shift
    ({"frame_shift": 40.0}, "fft"),                     # shift 640 > padded 512
    ({"frame_shift": 10.0625}, "fft"),                  # odd shift, 161 samples
    ({"num_mel_bins": 160}, "fft"),                     # more than 128 bins, 512 points
    ({"sample_rate": 44100}, "fft"),                    # 1102 samples, padded 2048
    ({"sample_rate": 48000, "frame_length": 42.6}, "fft"),  # 2044 samples, padded 2048
    ({"sample_rate": 48000, "frame_length": 50.0}, "fft"),  # 2400 samples, padded 4096
    ({"sample_rate": 44100, "num_mel_bins": 160}, "fft"),   # padded 2048, 160 bins
    ({"frame_length": 8.0}, "fft"),                     # 128 samples, padded 128
    ({"frame_length": 15.0, "sample_rate": 8000}, "fft"),   # 120 samples, padded 128
    ({"frame_length": 8.0, "sample_rate": 8000}, "fft"),    # 64 samples, padded 64
    ({"sample_rate": 96000}, "fft"),                    # 2400 samples, padded 4096
    ({"sample_rate": 96000, "frame_length": 42.6}, "fft"),  # 4089 samples, padded 4096
    ({"num_mel_bins": 1000}, "fft"),
    ({"sample_rate": 96000, "frame_length": 50.0}, "fft"),  # 4800 samples, padded 8192
    ({"sample_rate": 48000, "frame_length": 100.0}, "fft"),  # 4800 samples, padded 8192
    ({"sample_rate": 96000, "frame_length": 100.0}, "fft"),  # 9600 samples, padded 16384
    ({"sample_rate": 192000, "frame_length": 100.0}, "fft"),  # 19200, padded 32768
])
def test_route_picks_the_fft_kernel_for_its_geometries(kwargs, want):
    """Every padded window from 64 points up, any shift and any bin count
    goes to an FFT kernel (the block plan above 4096 points, C24): no route
    reaches the DFT kernel (C22, C23)."""
    assert fb.route(**kwargs) == want


@pytest.mark.parametrize("kwargs", [
    dict(frame_shift=0.01),                              # a shift of 0 samples
    dict(num_mel_bins=0)])
def test_route_refuses_what_no_kernel_takes(kwargs):
    """At a shift of 0 or no mel bins ``route`` and the FFT entry raise a
    ``ValueError`` that names the limit, in Python, never a CUDA error."""
    with pytest.raises(ValueError, match="shift|mel bins"):
        fb.route(**kwargs)
    with pytest.raises(ValueError, match="shift|mel bins"):
        fb.fbank_fft(torch.zeros(10000, dtype=torch.float32), **kwargs)


def test_dft_kernel_refuses_windows_past_its_shared_memory():
    """C23: the DFT kernel's two [32][win] float32 tiles fit 227 KB up to a
    window of 907 samples; ``fbank_dft`` refuses a longer one with a
    ``ValueError`` before it reaches the card (57 ms at 16 kHz: 912)."""
    assert fb.DFT_MAX_WIN == (232448 // 4 - 32) // 64
    with pytest.raises(ValueError, match="907"):
        fb.fbank_dft(torch.zeros(20000, dtype=torch.float32), frame_length=57.0)


def test_kernel_entries_refuse_cpu_tensors():
    """fbank_fft and fbank_dft launch kernels only; on the CPU the routed
    entry runs the plain version and launches nothing, at 16 kHz and at
    8192 points (the block plan's geometry)."""
    wave = torch.zeros(10000)
    block = dict(sample_rate=96000, frame_length=50.0)
    for entry, kw in ((fb.fbank_fft, {}), (fb.fbank_dft, {}), (fb.fbank_fft, block)):
        with pytest.raises(ValueError):
            entry(wave, **kw)
    before = (fb.fbank.launches, fb.fbank.fft_launches, fb.fbank.fft_block_launches)
    for kw in ({}, block):
        assert torch.equal(fb.fbank(wave, **kw), fb.fbank_plain(wave, **kw))
    assert (fb.fbank.launches, fb.fbank.fft_launches, fb.fbank.fft_block_launches) == before
