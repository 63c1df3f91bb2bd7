"""Kaldi-compatible log-mel filterbank features: CUDA kernel and plain version.

Counterpart of ``chunkformer_tpu/ops/fbank.py`` (``mel_banks`` :39,
``_window`` :78, ``num_frames`` :97, ``fbank`` :115) and of the TPU kernel
``chunkformer_tpu/ops/pallas/fbank.py:43 fbank_pallas``. The reference
computes features with ``torchaudio.compliance.kaldi.fbank``: framing with
snip_edges, per-frame DC removal, preemphasis 0.97, povey window, power
spectrum of the frame zero-padded to a power of two, Kaldi mel bank (the
Nyquist column is zero) and log. Dither is 0, as at decode time. The
waveform is float32 at int16 scale.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import kernels

_EPSILON = 1.1920928955078125e-07  # float32 eps, matches torch EPSILON
_PREEMPHASIS = 0.97


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


def fbank_plain(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
                frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Plain PyTorch version: [S] float32 -> [T, num_mel_bins] float32 (FFT power spectrum)."""
    win, shift, padded = _geometry(sample_rate, frame_length, frame_shift)
    n = num_frames(waveform.shape[0], sample_rate, frame_length, frame_shift)
    dev = waveform.device
    if n == 0:
        return torch.zeros((0, num_mel_bins), dtype=torch.float32, device=dev)
    frames = waveform.float()[: (n - 1) * shift + win].unfold(0, win, shift)  # [n, win]
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = (frames - _PREEMPHASIS * prev) * torch.from_numpy(povey_window(win)).to(dev)
    spectrum = torch.fft.rfft(frames, n=padded, dim=1).abs().square()
    banks = torch.from_numpy(mel_banks(num_mel_bins, padded, float(sample_rate))).to(dev)
    return torch.log(torch.clamp_min(spectrum @ banks, _EPSILON))


@functools.lru_cache(maxsize=4)
def _tables(win: int, padded: int, num_mel_bins: int, sample_rate: int, device: torch.device):
    """Kernel constants on the device: cos/sin [win, n_bins], window, mel."""
    n_bins = padded // 2 + 1
    ang = -2.0 * np.pi * np.arange(win)[:, None] * np.arange(n_bins)[None, :] / padded
    host = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            povey_window(win), mel_banks(num_mel_bins, padded, float(sample_rate)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


def fbank(waveform: torch.Tensor, num_mel_bins: int = 80, frame_length: float = 25.0,
          frame_shift: float = 10.0, sample_rate: int = 16000) -> torch.Tensor:
    """Log-mel features [T, num_mel_bins] float32 of a float32 waveform [S].

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernel of ``csrc/fbank.cu`` or raises.
    """
    if waveform.device.type == "cpu":
        return fbank_plain(waveform, num_mel_bins, frame_length, frame_shift, sample_rate)
    if waveform.device.type != "cuda":
        raise ValueError(f"fbank runs on cpu or cuda, not {waveform.device}")
    if waveform.dtype != torch.float32 or waveform.dim() != 1 or not waveform.is_contiguous():
        raise TypeError("fbank takes a contiguous 1-D float32 waveform")
    win, shift, padded = _geometry(sample_rate, frame_length, frame_shift)
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


fbank.launches = 0  # kernel launches since the last reset
