"""The native host library (``csrc/chunkformer_host.cc``), bound with ctypes.

Counterpart of ``chunkformer_tpu/native/__init__.py``: the same four entry
points (``ck_fbank_num_frames``, ``ck_fbank``, ``ck_resample_linear``,
``ck_quantize_int8``) and ABI version 1, compiled from the port's own copy of
the source with the JAX package's g++ flags, so its float results equal the
JAX package's library bit for bit. It is built at first use into
``build/chunkformer_tpu_torch/`` under a name keyed by the hash of the
source and the flags, written to a temporary file first and moved into place
(``ops/kernels.py``), so concurrent processes never load a half-written
library. A failed build raises with the compiler's log; nothing falls back
to numpy (``data/processor.py:compute_fbank_numpy`` is the plain version the
tests hold it against).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Tuple

import numpy as np

from ..ops import kernels

SOURCE = os.path.join(kernels.CSRC_DIR, "chunkformer_host.cc")
# chunkformer_tpu/native/__init__.py:40-42
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
ABI_VERSION = 1
WINDOW_TYPES = {"povey": 0, "hanning": 1, "hamming": 2, "rectangular": 3, "blackman": 4}

_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    return kernels.hashed_library_path("libcf_host", [SOURCE], GXX_FLAGS)


def build() -> str:
    """Compile the host library unless it exists; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.ck_abi_version.restype = ctypes.c_int
    lib.ck_abi_version.argtypes = []
    if lib.ck_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{library_path()}: ABI version {lib.ck_abi_version()}, "
                           f"expected {ABI_VERSION}")
    lib.ck_fbank_num_frames.restype = ctypes.c_int64
    lib.ck_fbank_num_frames.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                        ctypes.c_float]
    lib.ck_fbank.restype = ctypes.c_int64
    lib.ck_fbank.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_uint64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _F32P]
    lib.ck_resample_linear.restype = ctypes.c_int64
    lib.ck_resample_linear.argtypes = [_F32P, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                       _F32P, ctypes.c_int64]
    lib.ck_quantize_int8.restype = ctypes.c_float
    lib.ck_quantize_int8.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int8)]
    return lib


def fbank(waveform: np.ndarray, num_mel_bins: int = 80, frame_length: float = 25.0,
          frame_shift: float = 10.0, dither: float = 0.0, sample_rate: int = 16000,
          window_type: str = "povey", seed: int = 0, low_freq: float = 20.0,
          high_freq: float = 0.0, n_threads: int = 0) -> np.ndarray:
    """Kaldi log-mel fbank [frames, num_mel_bins] float32 of a mono wave (the
    semantics of ``data/processor.py:compute_fbank_numpy``); dither draws
    from the library's own generator, seeded by ``seed``. ``n_threads`` 0
    takes every core; the result does not depend on it."""
    if window_type not in WINDOW_TYPES:
        raise ValueError(f"unknown window type {window_type!r}")
    lib = library()
    wave = np.ascontiguousarray(waveform, dtype=np.float32)
    n = lib.ck_fbank_num_frames(wave.shape[0], sample_rate, frame_length, frame_shift)
    out = np.empty((max(n, 0), num_mel_bins), dtype=np.float32)
    if n <= 0:
        return out
    rc = lib.ck_fbank(wave.ctypes.data_as(_F32P), wave.shape[0], sample_rate, num_mel_bins,
                      frame_length, frame_shift, dither, seed, WINDOW_TYPES[window_type], 0.42,
                      low_freq, high_freq, 1, 1, 1, 1, n_threads, out.ctypes.data_as(_F32P))
    if rc != n:
        raise RuntimeError(f"ck_fbank returned {rc} frames, expected {n}")
    return out


def resample_linear(x: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Linear resampling of a mono wave: floor(len * out_rate / in_rate) samples."""
    lib = library()
    xin = np.ascontiguousarray(x, dtype=np.float32)
    n_out = int(xin.shape[0] * out_rate / in_rate)
    out = np.empty((n_out,), dtype=np.float32)
    rc = lib.ck_resample_linear(xin.ctypes.data_as(_F32P), xin.shape[0], in_rate, out_rate,
                                out.ctypes.data_as(_F32P), n_out)
    if rc != n_out:
        raise RuntimeError(f"ck_resample_linear returned {rc}, expected {n_out} samples")
    return out


def quantize_int8(x: np.ndarray, n_threads: int = 0) -> Tuple[np.ndarray, float]:
    """Symmetric int8 quantization with one global scale: (q, scale), scale =
    max(max|x|, 1e-6) / 127 in float32, q = clip(nearbyint(x * (1 / scale)),
    -127, 127) (round half to even)."""
    lib = library()
    xin = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(xin.shape, dtype=np.int8)
    scale = lib.ck_quantize_int8(xin.ctypes.data_as(_F32P), xin.size, n_threads,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if scale <= 0:
        raise RuntimeError("ck_quantize_int8 refused its input")
    return out, float(scale)
