"""The FFT fbank kernel's arithmetic (``csrc/fbank_fft.cu``), emulated step
for step in float32 numpy, against the port's plain version and the JAX
package's Pallas kernel; its tables, its tile walk and its route.

The emulation follows the kernel: frames of the waveform, the warp-sum mean,
preemphasis and window, the even/odd packing z[n] = x[2n] + i x[2n+1] of the
zero-padded frame, the radix-8 first stage and the radix-8/4 Stockham stages
in the kernel's order with the twiddle table the wrapper uploads, the real
split with the second table, all in float64; the power of bins k < padded / 2
rounded to float32, the sparse band table summed in ascending bin order, and
the log.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.ops.pallas.fbank import fbank_pallas
from chunkformer_tpu_torch.ops import fbank as fb

F32, F64 = np.float32, np.float64
SQRT_HALF = np.sqrt(0.5)


def _cmul(a, w):
    return np.stack([a[..., 0] * w[..., 0] - a[..., 1] * w[..., 1],
                     a[..., 0] * w[..., 1] + a[..., 1] * w[..., 0]], -1)


def _mul_neg_i(a):
    return np.stack([a[..., 1], -a[..., 0]], -1)


def _dft4(a):
    b0, b2 = a[0] + a[2], a[0] - a[2]
    b1, b3 = a[1] + a[3], _mul_neg_i(a[1] - a[3])
    return [b0 + b1, b2 + b3, b0 - b1, b2 - b3]


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


def fbank_emulated(wave, num_mel_bins=80, frame_length=25.0, frame_shift=10.0,
                   sample_rate=16000):
    """The FFT kernel's arithmetic in numpy: float64 from the float32
    samples, window and twiddle tables up to the power spectrum, then the
    float32 sparse mel product and log: [S] -> [T, num_mel_bins] float32."""
    win, shift, padded = fb._geometry(sample_rate, frame_length, frame_shift)
    n = fb.num_frames(wave.shape[0], sample_rate, frame_length, frame_shift)
    if n == 0:
        return np.zeros((0, num_mel_bins), F32)
    half = padded // 2
    twiddle, split = fb.fft_twiddles(padded)
    lanes = fb.mel_lanes(num_mel_bins, padded, float(sample_rate))
    x = wave.astype(F32)[np.arange(n)[:, None] * shift + np.arange(win)[None]].astype(F64)
    mean = x.sum(1) * (1.0 / win)
    xm = x - mean[:, None]
    prev = np.concatenate([xm[:, :1], xm[:, :-1]], 1)
    frames = np.zeros((n, padded), F64)
    frames[:, :win] = (xm - F64(F32(0.97)) * prev) * fb.povey_window(win).astype(F64)
    z = frames.reshape(n, half, 2)                       # z[m] = x[2m] + i x[2m+1]
    z = _stage(z, 8, 1, None)                            # the first stage, in registers
    for radix, p in fb.FFT_STAGES[padded]:
        z = _stage(z, radix, p, twiddle)
        twiddle = twiddle[(radix - 1) * p:]
    k = np.arange(half)
    zk, zm = z[:, k], z[:, (half - k) % half]
    u = _cmul(np.stack([zk[..., 0] - zm[..., 0], zk[..., 1] + zm[..., 1]], -1), split[None])
    re = 0.5 * (zk[..., 0] + zm[..., 0] + u[..., 1])
    im = 0.5 * (zk[..., 1] - zm[..., 1] - u[..., 0])
    power = (re * re + im * im).astype(F32)
    mel = np.zeros((n, num_mel_bins), F32)
    acc = np.zeros((n, lanes.shape[1]), F32)
    for step in lanes:                                   # all lanes take a step together
        bins, ends = step[:, 0] & 0xFFFF, step[:, 0] >> 16
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
    (16000, 25.0, 40.0), (44100, 25.0, 10.0), (16000, 25.0, 25.0), (8000, 25.0, 10.0)])
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
    (256, 256, 100000, 128, 8000), (2048, 1025, 3000, 80, 22050)])
def test_fft_tile_frames_fit_the_block(padded, win, shift, n_mels, sample_rate):
    """Across the FFT route's domain (window up to the padded size, any
    shift, up to 128 bins) a tile of at least as many frames as the block
    has warps fits the shared memory a block may take, and the 25 ms main
    path keeps its 16 frames at 75.8 KB (three blocks an SM)."""
    steps = fb.mel_lanes(n_mels, padded, float(sample_rate)).shape[0]
    frames = fb.fft_tile_frames(padded, win, shift, n_mels, steps)
    assert fb.fft_warps(padded) <= frames <= fb.FFT_MAX_TILE_FRAMES
    assert frames <= fb.fft_warps(padded) or frames % fb.fft_warps(padded) == 0
    assert fb.fft_smem_bytes(padded, win, shift, n_mels, steps, frames) <= fb.FFT_SMEM_BYTES
    if (padded, win, shift) == (512, 400, 160):
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
    (80, 1024, 16000), (80, 1024, 22050), (80, 2048, 44100), (128, 2048, 96000)])
def test_mel_lanes_rebuild_mel_banks(num_bins, padded, sample_rate):
    """Every band ends once, in one lane, its bins ascending and contiguous;
    scattering the steps back gives ``mel_banks`` bit for bit; a lane's
    steps after its last band are (0, 0.0); the lanes take as few steps as
    the widest band and the mean share allow."""
    lanes = fb.mel_lanes(num_bins, padded, float(sample_rate))
    want = fb.mel_banks(num_bins, padded, float(sample_rate))
    count = fb.band_table(num_bins, padded, float(sample_rate))[1]
    rebuilt = np.zeros_like(want)
    ended = []
    for lane in lanes.transpose(1, 0, 2):                # one lane's [steps, 2]
        start = 0
        for i, code in enumerate(lane[:, 0]):
            if code >> 16:
                m = (code >> 16) - 1
                bins, ws = lane[start:i + 1, 0] & 0xFFFF, lane[start:i + 1, 1].view(F32)
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
    ({"num_mel_bins": 160}, "dft"),                     # more than 128 bins
    ({"sample_rate": 44100}, "fft"),                    # 1102 samples, padded 2048
    ({"sample_rate": 48000, "frame_length": 42.6}, "fft"),  # 2044 samples, padded 2048
    ({"sample_rate": 48000, "frame_length": 50.0}, "dft"),  # 2400 samples, padded 4096
    ({"sample_rate": 44100, "num_mel_bins": 160}, "dft"),   # padded 2048, 160 bins
    ({"frame_length": 8.0}, "dft"),                     # 128 samples, padded 128
])
def test_route_picks_the_fft_kernel_for_its_geometries(kwargs, want):
    assert fb.route(**kwargs) == want


def test_kernel_entries_refuse_cpu_tensors():
    """fbank_fft and fbank_dft launch kernels only; on the CPU the routed
    entry runs the plain version and launches nothing."""
    wave = torch.zeros(4000)
    for entry in (fb.fbank_fft, fb.fbank_dft):
        with pytest.raises(ValueError):
            entry(wave)
    before = (fb.fbank.launches, fb.fbank.fft_launches)
    assert torch.equal(fb.fbank(wave), fb.fbank_plain(wave))
    assert (fb.fbank.launches, fb.fbank.fft_launches) == before
