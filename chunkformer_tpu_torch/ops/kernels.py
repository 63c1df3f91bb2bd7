"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface and no PyTorch headers;
the ``csrc/*.cuh`` headers hold the device code they share. Each ``.cu`` is
compiled by its own ``nvcc`` process, all started together, and the objects
are linked into one shared library, which is then loaded with ``ctypes``.
The build runs at first use into ``build/chunkformer_tpu_torch/`` beside the
package (a directory git ignores), under a name keyed by the hash of the
sources and headers, and is written to a temporary file first so concurrent
processes never load a half-written library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "chunkformer_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_F = ctypes.c_float


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def hashed_library_path(stem: str, sources, flags) -> str:
    """``BUILD_DIR/<stem>_<hash>.so``, the hash over the compiler flags and
    every source's name and bytes: a changed source or flag builds anew."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(sources):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    """Path of the shared library for the current sources and headers."""
    return hashed_library_path("libcf_kernels", glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                               + glob.glob(os.path.join(CSRC_DIR, "*.cuh")), NVCC_FLAGS)


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it exists; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    tmp = f"{path}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objects)]
    logs = []
    try:
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({proc.returncode}):\n{err}")
            logs.append(err)
        link = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", tmp, *objects], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    with open(path + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, path)
    return path


def build_log() -> str:
    """The compiler's report (ptxas registers and shared memory per kernel)."""
    with open(build() + ".log") as f:
        return f.read()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.cf_chunk_attention.argtypes = [_I] + [_P] * 9 + [_I] * 6 + [_L] * 10 + [_P]
    lib.cf_chunk_attention.restype = _I
    lib.cf_chunk_attention_tc.argtypes = [_I] + [_P] * 9 + [_I] * 6 + [_L] * 10 + [_P]
    lib.cf_chunk_attention_tc.restype = _I
    lib.cf_fbank.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.cf_fbank.restype = _I
    lib.cf_fbank_fft.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.cf_fbank_fft.restype = _I
    lib.cf_fbank_fft_block.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.cf_fbank_fft_block.restype = _I
    lib.cf_chunk_train_attn_fwd.argtypes = ([_I] + [_P] * 9 + [_I] * 7 + [_U, _U, _F, _I, _I, _I]
                                            + [_L] * 8 + [_P])
    lib.cf_chunk_train_attn_fwd.restype = _I
    lib.cf_chunk_train_attn_bwd.argtypes = ([_I] + [_P] * 18 + [_I] * 7 + [_U, _U, _F, _I, _I, _I]
                                            + [_L] * 11 + [_P])
    lib.cf_chunk_train_attn_bwd.restype = _I
    lib.cf_chunk_train_attn_tc_fwd.argtypes = ([_I] + [_P] * 9 + [_I] * 7 + [_U, _U, _F, _I, _I, _I]
                                               + [_L] * 8 + [_P])
    lib.cf_chunk_train_attn_tc_fwd.restype = _I
    lib.cf_chunk_train_attn_tc_bwd.argtypes = ([_I] + [_P] * 19 + [_I] * 9
                                               + [_U, _U, _F, _I, _I, _I]
                                               + [_L] * 11 + [_P])
    lib.cf_chunk_train_attn_tc_bwd.restype = _I
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch was refused (err is the cudaError_t it returned)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _counters() -> dict:
    """{name: (wrapper, attribute)} of every kernel wrapper's launch count:
    the decode attention (``chunk_attention``, ``chunk_attention_tc``), the
    training attention (``train_fwd``, ``train_bwd``, ``train_fwd_tc``,
    ``train_bwd_tc``) and the fbank (``fbank``, ``fbank_fft``,
    ``fbank_fft_block``)."""
    from .chunk_attention import chunk_attention
    from .chunk_attention_train import chunk_train_attention as train
    from .fbank import fbank

    return {"chunk_attention": (chunk_attention, "launches"),
            "chunk_attention_tc": (chunk_attention, "tc_launches"),
            "train_fwd": (train, "fwd_launches"), "train_bwd": (train, "bwd_launches"),
            "train_fwd_tc": (train, "fwd_tc_launches"),
            "train_bwd_tc": (train, "bwd_tc_launches"),
            "fbank": (fbank, "launches"), "fbank_fft": (fbank, "fft_launches"),
            "fbank_fft_block": (fbank, "fft_block_launches")}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its last reset, by the
    names of ``_counters``."""
    return {k: getattr(obj, attr) for k, (obj, attr) in _counters().items()}


def reset_launch_counts(*names: str) -> None:
    """Set the named launch counts (all of them with none named) to 0."""
    for k, (obj, attr) in _counters().items():
        if not names or k in names:
            setattr(obj, attr, 0)
