"""Positional encodings (copy of ``chunkformer_tpu/nn/embedding.py:22, :34, :49``).

``rel_pos_table`` is the symmetric relative-position sinusoid table of the
reference (modules/embedding.py:99-174, RelPositionalEncodingWithRightContext):
index ``center = max_len - 1`` is relative offset 0, entry k encodes offset
``center - k``.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=4)
def rel_pos_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """[2*max_len - 1, d_model] relative positional encodings."""
    center = max_len - 1
    k = np.arange(2 * max_len - 1, dtype=np.float64)
    rel = (center - k)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * max_len - 1, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(rel * div)
    pe[:, 1::2] = np.cos(rel * div)
    return pe.astype(np.float32)


def rel_pos_slice(d_model: int, chunk_size: int, left_context: int, right_context: int,
                  max_len: int = 5000) -> np.ndarray:
    """Slice covering the keys of one chunk: length 2*chunk - 1 + L + R
    (reference embedding.py:144-174: table[center - (c+L) + 1 : center + c + R])."""
    table = rel_pos_table(d_model, max_len)
    center = max_len - 1
    start = center - (chunk_size + left_context) + 1
    end = center + chunk_size + right_context
    if start < 0 or end > table.shape[0]:
        raise ValueError(f"chunk {chunk_size} with contexts {left_context}/{right_context} "
                         f"exceeds max_pos_len {max_len}")
    return table[start:end]


@functools.lru_cache(maxsize=4)
def abs_pos_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """[max_len, d_model] absolute positional encodings (the decoder's)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)
