"""Waveform-level distortion augmentations (the port's own copy of
``chunkformer_tpu/data/wav_distortion.py``).

Host-side numpy equivalents of the reference wav distortions
(reference: chunkformer/dataset/wav_distortion.py): amplitude-curve
distortions (poly/quad), max/fence value jittering, jag elimination, and gain
dB. Config-driven via `distort_wav_conf` with per-method probability.
All operate on float32 waveforms scaled to [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def db2amp(db: float) -> float:
    return 10 ** (db / 20)


def amp2db(amp: float) -> float:
    return 20 * np.log10(max(amp, 1e-12))


def distort_chain(x: np.ndarray, method: str, point_rate: float = 0.1,
                  rng: Optional[np.random.Generator] = None, **kw) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if method == "gain_db":
        return gain_db(x, kw.get("db", -6.0))
    if method == "max_distortion":
        return max_distortion(x, point_rate, rng, **kw)
    if method == "fence_distortion":
        return fence_distortion(x, point_rate, rng, **kw)
    if method == "jag_distortion":
        return jag_distortion(x, point_rate, rng)
    if method == "poly_distortion":
        return poly_distortion(x, **kw)
    if method == "quad_distortion":
        return quad_distortion(x)
    if method == "none":
        return x
    raise ValueError(f"unknown distortion {method}")


def gain_db(x: np.ndarray, db: float = -6.0) -> np.ndarray:
    return (x * db2amp(db)).astype(np.float32)


def max_distortion(x: np.ndarray, rate: float, rng, max_db: float = 0.0,
                   **_) -> np.ndarray:
    """Clamp a random subset of samples to +/- max amplitude."""
    threshold = db2amp(max_db)
    out = x.copy()
    mask = rng.random(x.shape) < rate
    out[mask & (x > 0)] = threshold
    out[mask & (x < 0)] = -threshold
    return out


def fence_distortion(x: np.ndarray, rate: float, rng, max_db: float = -30.0,
                     **_) -> np.ndarray:
    """Push a random subset of low-amplitude samples to a fence value."""
    fence = db2amp(max_db)
    out = x.copy()
    mask = (rng.random(x.shape) < rate) & (np.abs(x) < fence)
    out[mask & (x > 0)] = fence
    out[mask & (x < 0)] = -fence
    return out


def jag_distortion(x: np.ndarray, rate: float, rng) -> np.ndarray:
    """Sign-flip random samples (adds jagged noise)."""
    out = x.copy()
    mask = rng.random(x.shape) < rate
    out[mask] = -out[mask]
    return out


def poly_distortion(x: np.ndarray, a: float = 4.0, m: float = 2.0, n: float = 2.0,
                    **_) -> np.ndarray:
    """y = a * x^m * |x|^n * sign(x) amplitude curve, clipped to [-1, 1]."""
    y = a * np.power(np.abs(x), m + n) * np.sign(x)
    return np.clip(y, -1.0, 1.0).astype(np.float32)


def quad_distortion(x: np.ndarray) -> np.ndarray:
    return poly_distortion(x, a=1.0, m=1.0, n=1.0)


def distort_wav_conf(sample: Dict, conf: Dict,
                     rng: Optional[np.random.Generator] = None) -> Dict:
    """Pipeline stage: apply configured distortion with probability
    (reference wav_distortion.py:290-335). Operates on int16-scale waveforms."""
    rng = rng or np.random.default_rng()
    prob = conf.get("distortion_prob", 0.0)
    if rng.random() >= prob:
        return sample
    method = conf.get("distortion_method", "none")
    point_rate = conf.get("point_rate", 0.1)
    wav = sample["waveform"] / 32768.0
    wav = distort_chain(wav, method, point_rate, rng, **conf.get("params", {}))
    sample["waveform"] = (wav * 32768.0).astype(np.float32)
    return sample
