"""WAV loading for the port (counterpart of ``chunkformer_tpu/data/audio.py:40``).

Output convention matches the reference: mono float32 PCM at int16 scale
([-32768, 32767]), which is what the Kaldi fbank expects (reference
processor.py:226 multiplies by 1<<15). Only WAV is read here; other
containers need ffmpeg and are not part of this package yet.
"""

from __future__ import annotations

from math import gcd
from typing import Tuple

import numpy as np


def load_audio(path: str, sample_rate: int = 16000) -> Tuple[np.ndarray, int]:
    """Load a WAV file as mono float32 at int16 scale, resampled to `sample_rate`.

    Returns (waveform [n_samples], sample_rate).
    """
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32)
    elif data.dtype == np.int32:
        data = (data / 65536.0).astype(np.float32)
    elif data.dtype in (np.float32, np.float64):
        data = (data * 32768.0).astype(np.float32)
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported WAV sample type {data.dtype} in {path}")
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != sample_rate:
        from scipy.signal import resample_poly

        g = gcd(sr, sample_rate)
        data = resample_poly(data, sample_rate // g, sr // g).astype(np.float32)
    return np.ascontiguousarray(data, dtype=np.float32), sample_rate
