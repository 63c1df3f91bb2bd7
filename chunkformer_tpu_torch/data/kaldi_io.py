"""Kaldi ark/scp I/O: matrices, float/int vectors, posteriors (the port's
own copy of ``chunkformer_tpu/data/kaldi_io.py``; numpy and the standard
library only).

Covers the surface of the reference's vendored kaldi_io
(reference: chunkformer/dataset/kaldi_io.py — vestigial in the main decode
path but part of the public API): rx/wx specifiers (file, ``file:offset``,
``cmd |`` pipes, ``-`` stdio), binary and ascii matrices/vectors, compressed
matrices (``CM``), int-vector alignments, posteriors and confusion-network
time marks. Implementation is original, vectorized numpy; format layout per
the Kaldi compressed-matrix/holder specs.

Binary layout notes (Kaldi wire format):
- an ark stream is ``key<SP><value>`` records; binary values start ``\\0B``
- ``WriteBasicType``: one size byte (4 or 8) then the little-endian value
- float data: ``FV``/``DV`` (vector), ``FM``/``DM`` (matrix) token + dims
- int vector: dim then per-element size-prefixed int32
"""

from __future__ import annotations

import struct
import subprocess
import sys
from typing import IO, Iterator, List, Tuple

import numpy as np


class UnsupportedDataType(Exception):
    pass


class UnknownVectorHeader(Exception):
    pass


class UnknownMatrixHeader(Exception):
    pass


class BadSampleSize(Exception):
    pass


class BadInputFormat(Exception):
    pass


class SubprocessFailed(Exception):
    pass


# ----------------------------------------------------------------- specifiers

def popen(cmd: str, mode: str = "rb"):
    """Open a pipe to/from a shell command (kaldi 'cmd |' / '| cmd' style)."""
    if mode in ("r", "rb"):
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        return proc.stdout
    if mode in ("w", "wb"):
        proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        return proc.stdin
    raise ValueError(f"invalid pipe mode {mode!r}")


def open_or_fd(file, mode: str = "rb") -> IO:
    """Open a kaldi rx/wx specifier: a path, ``path:offset``, a ``cmd |`` or
    ``| cmd`` pipe, ``-`` for stdio, or pass a file object through."""
    if not isinstance(file, str):
        return file  # already a file-like object
    offset = None
    if file == "-":
        return sys.stdin.buffer if "r" in mode else sys.stdout.buffer
    if file.rstrip().endswith("|"):
        return popen(file.rstrip()[:-1], "rb")
    if file.lstrip().startswith("|"):
        return popen(file.lstrip()[1:], "wb")
    # strip ark/scp read prefixes ("ark:...", "scp,p:...")
    if ":" in file:
        head, _, tail = file.partition(":")
        if head.split(",")[0] in ("ark", "scp"):
            file = tail
    if ":" in file and file.rpartition(":")[2].isdigit():
        file, _, off = file.rpartition(":")
        offset = int(off)
    fd = open(file, mode if "b" in mode else mode + "b")
    if offset is not None:
        fd.seek(offset)
    return fd


def read_key(fd) -> str:
    """Read an utterance key (token up to a space); '' at end of stream."""
    chars = []
    while True:
        c = fd.read(1)
        if not c or c in (b" ", b"\n"):
            break
        chars.append(c)
    key = b"".join(chars).decode("latin1").strip()
    return key


def _expect_binary(fd) -> bool:
    """Consume the '\\0B' binary marker if present; return is_binary."""
    pos2 = fd.peek(2)[:2] if hasattr(fd, "peek") else None
    if pos2 is not None:
        if pos2 == b"\0B":
            fd.read(2)
            return True
        return False
    first = fd.read(2)
    if first == b"\0B":
        return True
    # non-seekable ascii stream: push back via wrapper
    raise BadInputFormat("ascii data on a non-peekable stream")


def _read_basic_int(fd) -> int:
    size = fd.read(1)
    if size == b"\x04":
        return struct.unpack("<i", fd.read(4))[0]
    if size == b"\x08":
        return struct.unpack("<q", fd.read(8))[0]
    raise BadSampleSize(f"unexpected int size byte {size!r}")


# ------------------------------------------------------------------- int vecs

def read_vec_int(file_or_fd) -> np.ndarray:
    """One int32 vector (alignment) from an rx specifier or fd."""
    fd = open_or_fd(file_or_fd)
    if _expect_binary(fd):
        dim = _read_basic_int(fd)
        # per-element: size byte + int32; read as a strided buffer
        raw = np.frombuffer(fd.read(5 * dim), dtype=np.uint8)
        if raw.size != 5 * dim:
            raise BadInputFormat("truncated int vector")
        if dim and not (raw[::5] == 4).all():
            raise BadSampleSize("int vector with non-int32 elements")
        return raw.reshape(dim, 5)[:, 1:].copy().view(np.int32).ravel() \
            if dim else np.zeros(0, np.int32)
    line = fd.readline().decode()
    return np.array([int(t) for t in line.strip().strip("[]").split()],
                    np.int32)


def read_vec_int_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_vec_int(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


# alignments are int vectors (reference: kaldi_io.py:161)
read_ali_ark = read_vec_int_ark


def read_vec_int_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rxfile = line.decode().strip().split(maxsplit=1)
            yield key, read_vec_int(rxfile)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_vec_int(file_or_fd, v, key: str = ""):
    fd = open_or_fd(file_or_fd, "wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        v = np.asarray(v, np.int32)
        fd.write(b"\x04" + struct.pack("<i", v.size))
        body = np.empty((v.size, 5), np.uint8)
        body[:, 0] = 4
        body[:, 1:] = v.reshape(-1, 1).view(np.uint8).reshape(-1, 4)
        fd.write(body.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


# ----------------------------------------------------------------- float vecs

def read_vec_flt(file_or_fd) -> np.ndarray:
    """One float vector from an rx specifier or fd (binary FV/DV or ascii)."""
    fd = open_or_fd(file_or_fd)
    if _expect_binary(fd):
        header = fd.read(3).decode()
        if header == "FV ":
            dtype, size = np.float32, 4
        elif header == "DV ":
            dtype, size = np.float64, 8
        else:
            raise UnknownVectorHeader(header)
        dim = _read_basic_int(fd)
        return np.frombuffer(fd.read(dim * size), dtype=dtype).copy()
    line = fd.readline().decode()
    return np.array([float(t) for t in line.strip().strip("[]").split()],
                    np.float32)


def read_vec_flt_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_vec_flt(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_flt_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rxfile = line.decode().strip().split(maxsplit=1)
            yield key, read_vec_flt(rxfile)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_vec_flt(file_or_fd, v, key: str = ""):
    fd = open_or_fd(file_or_fd, "wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        v = np.asarray(v)
        if v.dtype == np.float64:
            fd.write(b"DV ")
        else:
            v = v.astype(np.float32)
            fd.write(b"FV ")
        fd.write(b"\x04" + struct.pack("<i", v.size))
        fd.write(v.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


# ------------------------------------------------------------------- matrices

def _read_mat_binary(fd) -> np.ndarray:
    header = fd.read(3).decode()
    if header.startswith("CM"):
        return _read_compressed_mat(fd, header)
    if header == "FM ":
        dtype, size = np.float32, 4
    elif header == "DM ":
        dtype, size = np.float64, 8
    else:
        raise UnknownMatrixHeader(header)
    rows = _read_basic_int(fd)
    cols = _read_basic_int(fd)
    data = np.frombuffer(fd.read(rows * cols * size), dtype=dtype)
    if data.size != rows * cols:
        raise BadInputFormat("truncated matrix data")
    return data.reshape(rows, cols).copy()


def _read_mat_ascii(fd) -> np.ndarray:
    rows: List[np.ndarray] = []
    while True:
        line = fd.readline().decode()
        if not line:
            raise BadInputFormat("eof inside ascii matrix")
        toks = line.split()
        if not toks or toks == ["["]:
            continue
        closing = toks[-1] == "]"
        if closing:
            toks = toks[:-1]
        if toks and toks[0] == "[":
            toks = toks[1:]
        if toks:
            rows.append(np.array(toks, np.float32))
        if closing:
            return np.vstack(rows) if rows else np.zeros((0, 0), np.float32)


def _read_compressed_mat(fd, fmt: str) -> np.ndarray:
    """Kaldi CompressedMatrix, method 1 ('CM '): global (min,range) +
    per-column uint16 percentiles + uint8 codes, column-major."""
    if fmt != "CM ":
        raise UnsupportedDataType(f"compressed format {fmt!r} not supported")
    gmin, grange = struct.unpack("<ff", fd.read(8))
    rows = struct.unpack("<i", fd.read(4))[0]
    cols = struct.unpack("<i", fd.read(4))[0]
    pct = np.frombuffer(fd.read(8 * cols), dtype=np.uint16).reshape(cols, 4)
    pct = (gmin + grange * (1.0 / 65535.0) * pct.astype(np.float32))  # [cols,4]
    codes = np.frombuffer(fd.read(rows * cols), dtype=np.uint8) \
        .reshape(cols, rows).astype(np.float32)
    p0, p25, p75, p100 = (pct[:, i: i + 1] for i in range(4))
    low = p0 + (p25 - p0) * (codes / 64.0)
    mid = p25 + (p75 - p25) * ((codes - 64.0) / 128.0)
    high = p75 + (p100 - p75) * ((codes - 192.0) / 63.0)
    out = np.where(codes <= 64, low, np.where(codes <= 192, mid, high))
    return out.T.astype(np.float32)  # col-major -> row-major


def read_mat(file_or_fd) -> np.ndarray:
    """One matrix from an rx specifier or open fd (binary or ascii)."""
    fd = open_or_fd(file_or_fd)
    try:
        if _expect_binary(fd):
            return _read_mat_binary(fd)
        return _read_mat_ascii(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            if _expect_binary(fd):
                yield key, _read_mat_binary(fd)
            else:
                yield key, _read_mat_ascii(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rxfile = line.decode().strip().split(maxsplit=1)
            yield key, read_mat(rxfile)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_mat(file_or_fd, m, key: str = ""):
    """Write one binary float matrix (FM/DM per dtype)."""
    fd = open_or_fd(file_or_fd, "wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\0B")
        m = np.asarray(m)
        if m.dtype == np.float64:
            fd.write(b"DM ")
        else:
            m = m.astype(np.float32)
            fd.write(b"FM ")
        fd.write(b"\x04" + struct.pack("<i", m.shape[0]))
        fd.write(b"\x04" + struct.pack("<i", m.shape[1]))
        fd.write(m.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_ark_scp(key: str, mat, ark_fout, scp_out):
    """Write one matrix into an open ark and index it in an open scp."""
    ark_fout.write((key + " ").encode("latin1"))
    offset = ark_fout.tell()
    write_mat(ark_fout, mat)
    name = getattr(ark_fout, "name", "ark")
    scp_out.write(f"{key} {name}:{offset}\n")


# ----------------------------------------------------------------- posteriors

def read_post(file_or_fd) -> List[List[Tuple[int, float]]]:
    """One Posterior: per frame, a list of (int id, float weight) pairs."""
    fd = open_or_fd(file_or_fd)
    if not _expect_binary(fd):
        raise UnsupportedDataType("ascii posteriors not supported")
    n_frames = _read_basic_int(fd)
    post = []
    for _ in range(n_frames):
        n = _read_basic_int(fd)
        raw = np.frombuffer(fd.read(10 * n), dtype=np.uint8).reshape(n, 10)
        if n and not ((raw[:, 0] == 4).all() and (raw[:, 5] == 4).all()):
            raise BadSampleSize("posterior pair size bytes")
        ids = raw[:, 1:5].copy().view(np.int32).ravel()
        ws = raw[:, 6:10].copy().view(np.float32).ravel()
        post.append(list(zip(ids.tolist(), ws.tolist())))
    return post


def read_post_ark(file_or_fd) -> Iterator[Tuple[str, list]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_post(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


# lattice confusion networks are posteriors (reference: kaldi_io.py:647)
read_cnet_ark = read_post_ark


def read_cntime(file_or_fd) -> List[Tuple[float, float]]:
    """Confusion-network time marks: per frame (begin, end) float pair."""
    fd = open_or_fd(file_or_fd)
    if not _expect_binary(fd):
        raise UnsupportedDataType("ascii cntime not supported")
    n = _read_basic_int(fd)
    raw = np.frombuffer(fd.read(10 * n), dtype=np.uint8).reshape(n, 10)
    if n and not ((raw[:, 0] == 4).all() and (raw[:, 5] == 4).all()):
        raise BadSampleSize("cntime pair size bytes")
    begins = raw[:, 1:5].copy().view(np.float32).ravel()
    ends = raw[:, 6:10].copy().view(np.float32).ravel()
    return list(zip(begins.tolist(), ends.tolist()))


def read_cntime_ark(file_or_fd) -> Iterator[Tuple[str, list]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_cntime(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_segments_as_bool_vec(segments_file) -> np.ndarray:
    """Kaldi 'segments' file (one recording) -> 10 ms frame-level bool vector
    (True inside any segment), as in the reference tool surface."""
    segs = np.loadtxt(segments_file, dtype="object,object,f,f", ndmin=1)
    assert len(set(s[1] for s in segs)) == 1, "one recording per file"
    end = int(np.rint(max(s[3] for s in segs) * 100))
    vec = np.zeros(end, bool)
    for _, _, beg, fin in segs:
        vec[int(np.rint(beg * 100)): int(np.rint(fin * 100))] = True
    return vec


# ---------------------------------------------------- compact legacy wrappers
# (pre-round-3 surface of this module, kept for in-repo callers)

def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix|vector) pairs from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = read_key(f)
            if not key:
                return
            if not _expect_binary(f):
                yield key, _read_mat_ascii(f)
                continue
            # matrix or vector: peek the token
            tok = f.peek(3)[:3].decode()
            if tok in ("FV ", "DV "):
                f.read(3)
                dtype, size = (np.float32, 4) if tok == "FV " else (np.float64, 8)
                dim = _read_basic_int(f)
                yield key, np.frombuffer(f.read(dim * size), dtype=dtype).copy()
            else:
                yield key, _read_mat_binary(f)


def read_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix|vector) via `key ark_path:offset` lines."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            key, rxfile = line.strip().split(maxsplit=1)
            fd = open_or_fd(rxfile)
            try:
                if not _expect_binary(fd):
                    yield key, _read_mat_ascii(fd)
                    continue
                tok = fd.peek(3)[:3].decode()
                if tok in ("FV ", "DV "):
                    fd.read(3)
                    dtype, size = (np.float32, 4) if tok == "FV " \
                        else (np.float64, 8)
                    dim = _read_basic_int(fd)
                    yield key, np.frombuffer(fd.read(dim * size),
                                             dtype=dtype).copy()
                else:
                    yield key, _read_mat_binary(fd)
            finally:
                fd.close()


def write_ark(path: str, items, scp_path: str = None):
    """Write (key, float32 matrix|vector) pairs as binary ark [+ scp index]."""
    scp = open(scp_path, "w") if scp_path else None
    with open(path, "wb") as f:
        for key, mat in items:
            f.write(key.encode("latin1") + b" ")
            offset = f.tell()
            mat = np.asarray(mat, np.float32)
            if mat.ndim == 2:
                write_mat(f, mat)
            else:
                write_vec_flt(f, mat)
            if scp:
                scp.write(f"{key} {path}:{offset}\n")
    if scp:
        scp.close()
