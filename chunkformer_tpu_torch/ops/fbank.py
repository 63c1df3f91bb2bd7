"""Kaldi-compatible log-mel filterbank features: CUDA kernel and plain version.

Counterpart of ``chunkformer_tpu/ops/fbank.py`` (``mel_banks`` :39,
``_window`` :78, ``num_frames`` :97, ``fbank`` :115) and of the TPU kernel
``chunkformer_tpu/ops/pallas/fbank.py:43 fbank_pallas``. The reference
computes features with ``torchaudio.compliance.kaldi.fbank``: framing with
snip_edges, per-frame DC removal, preemphasis 0.97, povey window, power
spectrum of the frame zero-padded to a power of two, Kaldi mel bank (the
Nyquist column is zero) and log. Dither is 0, as at decode time. The
waveform is float32 at int16 scale.

``route`` sends every geometry to the FFT kernels, ``csrc/fbank_fft.cu``
up to 4096 padded points and ``csrc/fbank_fft_block.cu`` above: a float64
FFT written in the kernel and a sparse mel product, at any shift and any
mel count. Up to 4096 points a warp takes a frame (a window padded to 64 or
128 points runs the 256-point plan and reads every (256 / padded)-th bin;
4096 points run an in-place plan of their own); above, a block of 256
threads takes a frame, its buffer in shared memory up to 16384 points and
in a global workspace beyond (``fft_block_in_shared``). ``csrc/fbank.cu``
(the DFT as a float32 product with cos/sin tables) is no route's kernel: it
stays as the yardstick that ``chip_smoke.py`` times the FFT kernel against.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import kernels

_EPSILON = 1.1920928955078125e-07  # float32 eps, matches torch EPSILON
_PREEMPHASIS = float(np.float32(0.97))  # Kaldi's float coefficient, as float32 pipelines apply it


def _mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, padded_window_size: int, sample_rate: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel filterbank matrix, shape [padded_window_size//2 + 1, num_bins]."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    assert 0.0 <= low_freq < high_freq <= nyquist
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_rate / padded_window_size

    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    mel = _mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))

    full = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float64)
    full[:, :num_fft_bins] = banks
    return np.ascontiguousarray(full.T.astype(np.float32))


@functools.lru_cache(maxsize=8)
def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    a = 2.0 * math.pi / (window_size - 1)
    return ((0.5 - 0.5 * np.cos(a * n)) ** 0.85).astype(np.float32)


def num_frames(num_samples: int, sample_rate: int = 16000, frame_length: float = 25.0,
               frame_shift: float = 10.0) -> int:
    """Number of output frames under snip_edges=True framing."""
    window_size = int(sample_rate * frame_length * 0.001)
    window_shift = int(sample_rate * frame_shift * 0.001)
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


def _geometry(sample_rate: int, frame_length: float, frame_shift: float):
    win = int(sample_rate * frame_length * 0.001)
    shift = int(sample_rate * frame_shift * 0.001)
    return win, shift, 1 << (win - 1).bit_length()


def windowed_frames(waveform: torch.Tensor, win: int, shift: int, n: int) -> torch.Tensor:
    """The n frames of ``fbank_plain``, float64 [n, win] from the float32
    samples: DC removed, preemphasised, windowed."""
    frames = waveform.float()[: (n - 1) * shift + win].unfold(0, win, shift).double()
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    window = torch.from_numpy(povey_window(win)).to(waveform.device).double()
    return (frames - _PREEMPHASIS * prev) * window


def fbank_plain(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
                frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Plain PyTorch version: [S] float32 -> [T, num_mel_bins] float32.

    It computes in float64 from the float32 samples, window and mel bank:
    a frame's quietest bands (the DC-removed, preemphasised low bins) can
    lie 120 dB under its loudest bins, where a float32 FFT's rounding moves
    their log by more than the kernels' bar of 2e-3."""
    win, shift, padded = _geometry(sample_rate, frame_length, frame_shift)
    n = num_frames(waveform.shape[0], sample_rate, frame_length, frame_shift)
    dev = waveform.device
    if n == 0:
        return torch.zeros((0, num_mel_bins), dtype=torch.float32, device=dev)
    frames = windowed_frames(waveform, win, shift, n)
    spectrum = torch.fft.rfft(frames, n=padded, dim=1).abs().square()
    banks = torch.from_numpy(mel_banks(num_mel_bins, padded, float(sample_rate))).to(dev)
    return torch.log(torch.clamp_min(spectrum @ banks.double(), _EPSILON)).float()


# The FFT kernel's Stockham stages after its first radix-8 one, as (radix R,
# points combined before it P), by the plan's points (csrc/fbank_fft.cu
# later_stages). The 4096-point plan is no Stockham walk: an in-place
# decimation in frequency of radices FFT_DIF_RADICES, whose twiddles are
# the split table's (``fft_twiddles``).
FFT_STAGES = {2048: ((8, 8), (4, 64), (4, 256)), 1024: ((8, 8), (8, 64)),
              512: ((8, 8), (4, 64)), 256: ((4, 8), (4, 32))}
FFT_DIF_RADICES = {4096: (8, 8, 8, 4)}
# Padded windows the warp plans take (csrc/fbank_fft.cu): 64 and 128 points
# run the 256-point plan (``fft_points``); longer windows run the block plan
# (csrc/fbank_fft_block.cu), a block of FFT_BLOCK_THREADS threads a frame
MIN_FFT_PLAN = 256
MAX_WARP_PLAN_POINTS = 4096
FFT_BLOCK_THREADS = 256
# The mel lane table's steps keep a band's number + 1 in 16 bits
MAX_FFT_MELS = 0xFFFF
# The FFT kernel's blocks (csrc/fbank_fft.cu): shared memory a block may opt
# into on sm_90 (227 KB on an H100), and frames a tile at most
FFT_SMEM_BYTES = 232448
# Shared memory an H100 SM holds for its resident blocks (228 KB), and what
# the runtime reserves of it for each block
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
FFT_MAX_TILE_FRAMES = 16
# The DFT kernel (csrc/fbank.cu) keeps two [32][win] float32 tiles in shared
# memory: windows above this many samples do not fit 227 KB (C23)
DFT_MAX_WIN = 907


def fft_points(padded: int) -> int:
    """Points of the FFT plan that computes a padded window: the window's own
    from 256 up, 256 below. A frame that is zero past its window has X_P[k]
    = X_256[k 256 / P], so a P-point window reads every (256 / P)-th bin of
    the 256-point plan."""
    return max(padded, MIN_FFT_PLAN)


def route(num_mel_bins: int = 80, frame_length: float = 25.0, frame_shift: float = 10.0,
          sample_rate: int = 16000) -> str:
    """Which kernel a CUDA call launches, from the geometry alone: "fft"
    (``csrc/fbank_fft.cu`` up to ``MAX_WARP_PLAN_POINTS`` padded points,
    ``csrc/fbank_fft_block.cu`` above) for every window of at least 2
    samples, any shift > 0 and any mel count up to ``MAX_FFT_MELS``. Raises
    a ``ValueError`` naming the limit otherwise."""
    win, shift, _ = _geometry(sample_rate, frame_length, frame_shift)
    if win < 2 or shift < 1:
        raise ValueError(f"fbank needs a window of at least 2 samples and a shift of at least "
                         f"1, got {win} and {shift}")
    if not 0 < num_mel_bins <= MAX_FFT_MELS:
        raise ValueError(f"the FFT fbank kernel takes 1 to {MAX_FFT_MELS} mel bins, not "
                         f"{num_mel_bins}")
    return "fft"


def fft_block_radices(padded: int) -> tuple:
    """The block plan's stages (``csrc/fbank_fft_block.cu``), an in-place
    decimation in frequency of the padded / 2 complex points: radix 8 while
    three or more bits are left, then one stage of radix 4 or 2. The
    4096-point warp plan's ``FFT_DIF_RADICES`` follow the same rule."""
    bits = (padded // 2).bit_length() - 1
    return (8,) * (bits // 3) + ((1 << bits % 3,) if bits % 3 else ())


def fft_block_in_shared(padded: int) -> bool:
    """Whether the block plan keeps a frame's buffer (padded / 2 complex
    float64, 16 bytes each) in shared memory, beside the 64 bytes of its
    warps' partial sums: up to 16384 points (128 KB) within
    ``FFT_SMEM_BYTES``; from 32768 points (256 KB) it takes a slot of a
    global workspace."""
    return 8 * padded + 8 * FFT_BLOCK_THREADS // 32 <= FFT_SMEM_BYTES


def fft_block_grid(padded: int, n_frames: int, sms: int) -> int:
    """The block plan's persistent grid, never more blocks than frames. With
    the frame's buffer in shared memory: as many blocks an SM as its
    ``SM_SMEM_BYTES`` hold (each block reserving ``BLOCK_RESERVED_SMEM``),
    at most the 2 the kernel's registers admit (``__launch_bounds__(256,
    2)``): 2 at 8192 points, 1 at 16384. With a workspace: one block an SM,
    each with its own slot (256 KB a slot at 32768 points, 33.8 MB over an
    H100's 132 SMs, within its 50 MB L2)."""
    if fft_block_in_shared(padded):
        per_sm = min(2, SM_SMEM_BYTES // (8 * padded + 8 * FFT_BLOCK_THREADS // 32
                                          + BLOCK_RESERVED_SMEM))
    else:
        per_sm = 1
    return max(1, min(n_frames, per_sm * sms))


def fft_block_workspace_bytes(padded: int, blocks: int) -> int:
    """Bytes of the global workspace the block plan's wrapper allocates for a
    grid of ``blocks``: none where the buffer fits shared memory, else a
    buffer a block."""
    return 0 if fft_block_in_shared(padded) else blocks * 8 * padded


def fft_warps(padded: int) -> int:
    """Warps (one frame each) of an FFT kernel block (``warps`` in
    ``csrc/fbank_fft.cu``) for a padded window: two at 4096 points, where
    each warp's float64 buffer takes 32 KB, four at 2048 (16 KB), eight
    otherwise."""
    return {4096: 2, 2048: 4}.get(fft_points(padded), 8)


def _round4(x: int) -> int:
    return (x + 3) & ~3


def fft_tile_span(win: int, shift: int, tile_frames: int) -> int:
    """Floats of one tile buffer (``tile_span`` in ``csrc/fbank_fft.cu``):
    overlapping or touching frames (shift <= win) share one run of
    (tile_frames - 1) * shift + win samples; frames with gaps between them
    are copied one by one into slots of round4(win + 3) floats. Either copy
    may start 3 samples early, at a 16-byte boundary."""
    if shift > win:
        return tile_frames * _round4(win + 3)
    return _round4((tile_frames - 1) * shift + win + 3)


def fft_smem_bytes(padded: int, win: int, shift: int, num_mel_bins: int, mel_steps: int,
                   tile_frames: int) -> int:
    """Shared memory of an FFT kernel block (``Layout`` in
    ``csrc/fbank_fft.cu``) for a padded window: the stage twiddles (none in
    the 4096-point plan) and the split factors, the warps' FFT buffers
    (float64 complex), two tile buffers, the tile's staged output rows, the
    window as float64 and the mel lane table."""
    n = fft_points(padded) // 2
    stages = 0 if n == 2048 else 4 * n
    floats = (stages + 4 * n + 4 * n * fft_warps(padded)
              + 2 * fft_tile_span(win, shift, tile_frames)
              + _round4(tile_frames * num_mel_bins) + 2 * _round4(win) + 64 * mel_steps)
    return 4 * floats


def fft_tile_frames(padded: int, win: int, shift: int, num_mel_bins: int,
                    mel_steps: int) -> int:
    """Frames a tile of the FFT kernel: the most, up to
    ``FFT_MAX_TILE_FRAMES``, whose block fits ``FFT_SMEM_BYTES``, cut to a
    multiple of the block's warps when it has more frames than warps (a
    last round with idle warps costs as much as a full one). Raises a
    ``ValueError`` where not even one frame fits (a mel count in the
    thousands at a window of thousands of samples)."""
    for frames in range(FFT_MAX_TILE_FRAMES, 0, -1):
        if fft_smem_bytes(padded, win, shift, num_mel_bins, mel_steps,
                          frames) <= FFT_SMEM_BYTES:
            warps = fft_warps(padded)
            return frames - frames % warps if frames > warps else frames
    raise ValueError(f"no FFT tile fits {FFT_SMEM_BYTES} bytes at padded {padded}, win {win}, "
                     f"shift {shift}, {num_mel_bins} mel bins")


@functools.lru_cache(maxsize=8)
def fft_twiddles(padded: int) -> tuple[np.ndarray, np.ndarray]:
    """The FFT kernel's twiddle tables for the plan of ``padded`` points, in
    float64, [rows, 2] (re, im): for each stage (R, P) of ``FFT_STAGES`` in
    turn, exp(-2 pi i k j / (P R)) at row (j - 1) P + k, j = 1..R-1, k < P
    (no rows for the 4096-point plan, whose stages take their twiddles
    W_N^e = W_padded^(2e) from the split table); and exp(-2 pi i k /
    padded), k < padded / 2, for the real split."""
    k = np.arange(padded // 2, dtype=np.float64)
    stages = [np.exp(-2j * np.pi * np.outer(np.arange(1, r), np.arange(p)) / (p * r)).reshape(-1)
              for r, p in FFT_STAGES.get(padded, ())]
    stages = np.concatenate(stages) if stages else np.zeros(0, np.complex128)
    split = np.exp(-2j * np.pi * k / padded)
    return tuple(np.ascontiguousarray(np.stack([w.real, w.imag], axis=1))
                 for w in (stages, split))


@functools.lru_cache(maxsize=8)
def band_table(num_bins: int, padded_window_size: int, sample_rate: float):
    """The mel bank as contiguous bands: for band m, the bins
    [first[m], first[m] + count[m]) with weights
    weights[offset[m]:offset[m] + count[m]], copied from ``mel_banks``
    (every other entry of its column is an exact zero). Returns int32
    first, count, offset [num_bins] and float32 weights [sum(count)]."""
    banks = mel_banks(num_bins, padded_window_size, sample_rate)
    first = np.zeros(num_bins, np.int32)
    count = np.zeros(num_bins, np.int32)
    weights = []
    for m in range(num_bins):
        nz = np.flatnonzero(banks[:, m])
        if nz.size:
            first[m], count[m] = nz[0], nz[-1] - nz[0] + 1
            weights.append(banks[nz[0]:nz[-1] + 1, m])
    offset = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int32)
    weights = np.concatenate(weights) if weights else np.zeros(0, np.float32)
    return first, count, offset, np.ascontiguousarray(weights, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def mel_lanes(num_bins: int, padded_window_size: int, sample_rate: float) -> np.ndarray:
    """The band table dealt to the 32 lanes of a warp for the FFT kernel:
    int32 [steps, 32, 2]. Whole bands go to lanes by best-fit decreasing,
    widest band first, each to the fullest lane it still fits under a
    budget of steps a lane; the budget starts at the larger of the widest
    band and the mean share and grows until every band fits. A lane walks
    its bands in ascending order, each band's bins in ascending order. A
    step is (bin of the kernel's plan, the float32 weight's bits), with
    band + 1 in the bin's high 16 bits at a band's last bin (where the
    kernel stores the sum); a band without bins is one step of weight 0.
    Lanes with fewer steps end in (0, 0.0). A padded window below the
    256-point plan (``fft_points``) reads every (256 / padded)-th bin of it:
    bin k of the window is the plan's bin k * 256 / padded."""
    lanes = 32
    first, count, offset, weights = band_table(num_bins, padded_window_size, sample_rate)
    if int((first + count).max()) > padded_window_size // 2:
        raise ValueError("a mel band reaches the Nyquist bin, which the FFT kernel does "
                         "not compute")
    stride = fft_points(padded_window_size) // padded_window_size
    steps = np.maximum(count, 1)
    depth = max(int(steps.max()), -(-int(steps.sum()) // lanes))
    while True:
        load, bands = [0] * lanes, [[] for _ in range(lanes)]
        for m in sorted(range(num_bins), key=lambda b: (-steps[b], b)):
            fits = [i for i in range(lanes) if load[i] + steps[m] <= depth]
            if not fits:
                break
            lane = max(fits, key=lambda i: (load[i], -i))
            load[lane] += steps[m]
            bands[lane].append(m)
        else:
            break
        depth += 1
    bits = weights.view(np.int32)
    table = np.zeros((depth, lanes, 2), np.int64)
    for lane, ms in enumerate(bands):
        cells = []
        for m in sorted(ms):
            band = [[(first[m] + b) * stride, bits[offset[m] + b]]
                    for b in range(count[m])] or [[0, 0]]
            band[-1][0] |= (m + 1) << 16
            cells += band
        table[:len(cells), lane] = np.asarray(cells, np.int64).reshape(-1, 2)
    return (table & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=4)
def _fft_tables(win: int, padded: int, num_mel_bins: int, sample_rate: int,
                device: torch.device):
    """FFT kernel constants on the device: both twiddle tables of the plan,
    the window and the mel lane table."""
    host = (*fft_twiddles(fft_points(padded)), povey_window(win),
            mel_lanes(num_mel_bins, padded, float(sample_rate)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


@functools.lru_cache(maxsize=4)
def _fft_block_tables(win: int, padded: int, num_mel_bins: int, sample_rate: int,
                      device: torch.device):
    """Block plan constants on the device: the split table, the window, the
    bands int32 [n_mels, 4] (first bin, bins, first weight, 0) and their
    float32 weights (``band_table``)."""
    first, count, offset, weights = band_table(num_mel_bins, padded, float(sample_rate))
    bands = np.stack([first, count, offset, np.zeros_like(first)], axis=1)
    host = (fft_twiddles(padded)[1], povey_window(win), bands, weights)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


@functools.lru_cache(maxsize=4)
def _tables(win: int, padded: int, num_mel_bins: int, sample_rate: int, device: torch.device):
    """Kernel constants on the device: cos/sin [win, n_bins], window, mel."""
    n_bins = padded // 2 + 1
    ang = -2.0 * np.pi * np.arange(win)[:, None] * np.arange(n_bins)[None, :] / padded
    host = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            povey_window(win), mel_banks(num_mel_bins, padded, float(sample_rate)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


def _check_waveform(waveform: torch.Tensor) -> None:
    if waveform.device.type != "cuda":
        raise ValueError(f"the fbank kernels run on cuda, not {waveform.device}")
    if waveform.dtype != torch.float32 or waveform.dim() != 1 or not waveform.is_contiguous():
        raise TypeError("fbank takes a contiguous 1-D float32 waveform")


def fbank_dft(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
              frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Launch the DFT kernel (``csrc/fbank.cu``) on a CUDA waveform. No route
    reaches it: it is the yardstick the FFT kernel is timed against. It
    sums its cos/sin products in float32, so on tonal audio a rare element
    misses the bar of 2e-3 + 1e-3 |plain| (C22: about 1 in 320,000 at 25
    and 40 ms shifts on an H100); it refuses, with a ``ValueError``, windows
    above ``DFT_MAX_WIN`` samples, whose tiles do not fit its shared memory
    (C23)."""
    win, shift, padded = _geometry(sample_rate, frame_length, frame_shift)
    if win > DFT_MAX_WIN or shift < 1:
        raise ValueError(f"the DFT fbank kernel takes windows of at most {DFT_MAX_WIN} samples "
                         f"and a shift of at least 1, not {win} and {shift}")
    _check_waveform(waveform)
    n = num_frames(waveform.shape[0], sample_rate, frame_length, frame_shift)
    out = torch.empty((n, num_mel_bins), dtype=torch.float32, device=waveform.device)
    if n == 0:
        return out
    cos_t, sin_t, window, mel = _tables(win, padded, num_mel_bins, sample_rate,
                                        waveform.device)
    lib = kernels.library()
    with torch.cuda.device(waveform.device):
        err = lib.cf_fbank(waveform.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
                           window.data_ptr(), mel.data_ptr(), out.data_ptr(), n, win,
                           shift, padded // 2 + 1, num_mel_bins,
                           torch.cuda.current_stream(waveform.device).cuda_stream)
    kernels.check(err, "fbank")
    fbank.launches += 1
    return out


def fbank_fft(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
              frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Launch the FFT kernel of the geometry's plan on a CUDA waveform:
    ``csrc/fbank_fft.cu`` up to 4096 padded points, ``csrc/fbank_fft_block.cu``
    above (with a workspace from ``torch.empty`` past 16384 points); raises
    a ``ValueError`` on a geometry ``route`` refuses. The waveform may start
    at any 4-byte address: the warp plans copy 16 bytes a thread from a
    16-byte-aligned one and 4 bytes a thread otherwise, the block plan reads
    4 bytes a thread."""
    route(num_mel_bins, frame_length, frame_shift, sample_rate)
    _check_waveform(waveform)
    win, shift, padded = _geometry(sample_rate, frame_length, frame_shift)
    n = num_frames(waveform.shape[0], sample_rate, frame_length, frame_shift)
    out = torch.empty((n, num_mel_bins), dtype=torch.float32, device=waveform.device)
    if n == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(waveform.device).cuda_stream
    if padded > MAX_WARP_PLAN_POINTS:
        split, window, bands, weights = _fft_block_tables(win, padded, num_mel_bins,
                                                          sample_rate, waveform.device)
        blocks = fft_block_grid(padded, n, torch.cuda.get_device_properties(
            waveform.device).multi_processor_count)
        workspace = None
        if not fft_block_in_shared(padded):
            workspace = torch.empty(fft_block_workspace_bytes(padded, blocks) // 8,
                                    dtype=torch.float64, device=waveform.device)
        with torch.cuda.device(waveform.device):
            err = lib.cf_fbank_fft_block(
                waveform.data_ptr(), split.data_ptr(), window.data_ptr(), bands.data_ptr(),
                weights.data_ptr(), out.data_ptr(),
                None if workspace is None else workspace.data_ptr(), n, win, shift, padded,
                num_mel_bins, blocks, stream)
        kernels.check(err, "fbank_fft_block")
        fbank.fft_block_launches += 1
        return out
    twiddle, split, window, mel = _fft_tables(win, padded, num_mel_bins, sample_rate,
                                              waveform.device)
    with torch.cuda.device(waveform.device):
        err = lib.cf_fbank_fft(waveform.data_ptr(), twiddle.data_ptr(), split.data_ptr(),
                               window.data_ptr(), mel.data_ptr(), out.data_ptr(), n, win,
                               shift, fft_points(padded), num_mel_bins, mel.shape[0],
                               fft_tile_frames(padded, win, shift, num_mel_bins, mel.shape[0]),
                               stream)
    kernels.check(err, "fbank_fft")
    fbank.fft_launches += 1
    return out


def fbank(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
          frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Log-mel features [T, num_mel_bins] float32 of a float32 waveform [S].

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the FFT kernel, or raises where ``route`` refuses the geometry.
    """
    if waveform.device.type == "cpu":
        return fbank_plain(waveform, num_mel_bins, frame_length, frame_shift, sample_rate)
    return fbank_fft(waveform, num_mel_bins, frame_length, frame_shift, sample_rate)


def fbank_batch(waveforms: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 80,
                frame_length: float = 25.0, frame_shift: float = 10.0,
                sample_rate: int = 16000) -> tuple:
    """``fbank`` of each padded waveform of [B, max_samples] float32
    (``chunkformer_tpu/ops/fbank.py:189``): (feats [B, max_frames,
    num_mel_bins], frame lengths [B]). Frames past a row's own count are
    the fbank of its zero padding; mask them with the frame lengths. One
    kernel launch a row on a card."""
    feats = torch.stack([fbank(w, num_mel_bins, frame_length, frame_shift, sample_rate)
                         for w in waveforms])
    window_size = int(sample_rate * frame_length * 0.001)
    window_shift = int(sample_rate * frame_shift * 0.001)
    frame_lengths = torch.clamp_min(1 + torch.div(lengths - window_size, window_shift,
                                                  rounding_mode="floor"), 0)
    return feats, frame_lengths


fbank.launches = 0      # DFT kernel launches (csrc/fbank.cu) since the last reset
fbank.fft_launches = 0  # warp-plan FFT kernel launches (csrc/fbank_fft.cu) since the last reset
fbank.fft_block_launches = 0  # block-plan FFT kernel launches (csrc/fbank_fft_block.cu)
