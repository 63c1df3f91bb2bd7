"""Relative-position score shift with asymmetric left/right context.

Counterpart of ``chunkformer_tpu/ops/relshift.py:21`` (reference:
chunkformer/modules/attention.py:242-266). Used only by the plain chunk
attention; the CUDA kernel indexes the positional rows directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_shift(x: torch.Tensor, left_context: int = 0, right_context: int = 0) -> torch.Tensor:
    """[..., T, N] -> [..., T, T + L + R] with ``out[..., i, j] = x[..., i, (T-1) - i + j]``.

    N must be 2*T - 1 + L + R. Pad one column, flatten, shift, reshape.
    """
    *lead, t, n = x.shape
    assert n == 2 * t - 1 + left_context + right_context, (x.shape, left_context, right_context)
    x = F.pad(x, (0, 1)).reshape(*lead, t * (n + 1))
    x = x[..., t - 1: t - 1 + t * n].reshape(*lead, t, n)
    return x[..., :t + left_context + right_context]
