"""Host-side audio I/O: decode, resample, speed perturb (counterpart of
``chunkformer_tpu/data/audio.py``).

Output convention matches the reference: mono float32 PCM at int16 scale
([-32768, 32767]), which is what the Kaldi fbank expects (reference
processor.py:226 multiplies by 1<<15). WAV is decoded with scipy; other
containers go through ffmpeg when it is installed and raise otherwise.
"""

from __future__ import annotations

import io
import shutil
import subprocess
from math import gcd
from typing import Optional, Tuple

import numpy as np


def _resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def _decode_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"cannot decode {path}: not a WAV file and ffmpeg unavailable")
    out = subprocess.run(
        ["ffmpeg", "-v", "quiet", "-i", path, "-f", "s16le", "-acodec", "pcm_s16le",
         "-ac", "1", "-ar", str(sample_rate), "-"],
        check=True, capture_output=True).stdout
    return np.frombuffer(out, dtype=np.int16).astype(np.float32)


def _to_int16_scale(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32)
    if data.dtype == np.int32:
        return (data / 65536.0).astype(np.float32)
    if data.dtype in (np.float32, np.float64):
        return (data * 32768.0).astype(np.float32)
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) * 256.0
    raise ValueError(f"unsupported WAV sample type {data.dtype}")


def load_audio(path: str, sample_rate: int = 16000, start: Optional[float] = None,
               end: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Load audio as mono float32 at int16 scale, resampled to `sample_rate`,
    cut to [start, end) seconds when given.

    Returns (waveform [n_samples], sample_rate).
    """
    data = None
    if path.lower().endswith(".wav"):
        from scipy.io import wavfile

        try:
            sr, raw = wavfile.read(path)
        except ValueError:
            raw = None
        if raw is not None:
            data = _to_int16_scale(raw)
            if data.ndim == 2:
                data = data.mean(axis=1)
            if sr != sample_rate:
                data = _resample_poly(data, sr, sample_rate)
    if data is None:
        data = _decode_ffmpeg(path, sample_rate)
    if start is not None or end is not None:
        s = int((start or 0.0) * sample_rate)
        e = int(end * sample_rate) if end is not None else len(data)
        data = data[s:e]
    return np.ascontiguousarray(data, dtype=np.float32), sample_rate


def load_wav_bytes(raw: bytes, sample_rate: int = 16000) -> np.ndarray:
    """Decode in-memory WAV bytes (the tar-shard pipeline)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(io.BytesIO(raw))
    data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != sample_rate:
        data = _resample_poly(data, sr, sample_rate)
    return data


def speed_perturb(x: np.ndarray, speed: float, sample_rate: int = 16000) -> np.ndarray:
    """Tempo change by resampling (reference: processor.py:183-208 uses sox
    `speed`, which is resampling without pitch correction)."""
    if speed == 1.0:
        return x
    return _resample_poly(x, int(round(sample_rate * speed)), sample_rate)


def resample_linear(x: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Linear resampling through the native host library (``native.resample_linear``,
    the JAX package's ``chunkformer_tpu.native.resample_linear``):
    floor(len * out_rate / in_rate) samples, float32."""
    from .. import native

    return native.resample_linear(x, in_rate, out_rate)
