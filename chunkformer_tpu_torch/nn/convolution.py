"""Chunk-aware Conformer convolution module, parallel-chunk mode
(counterpart of ``chunkformer_tpu/nn/convolution.py:128 conv_parallel_chunk``).

Reference: chunkformer/modules/convolution.py:194-255. Pointwise-GLU ->
depthwise conv over overlapping windows of the flat stream (cache prefix,
lorder zero columns at the end) -> norm -> swish -> pointwise, with the conv
mask applied before the depthwise conv and to the output.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvolutionModule(nn.Module):
    """Parameter names as the reference ChunkConvolutionModule."""

    def __init__(self, channels: int, kernel_size: int = 15, norm: str = "batch_norm"):
        super().__init__()
        self.lorder = kernel_size // 2
        self.use_layer_norm = norm == "layer_norm"
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)
        self.norm = nn.LayerNorm(channels) if self.use_layer_norm else nn.BatchNorm1d(channels)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def parallel_chunk(
        self, x: torch.Tensor, conv_mask: torch.Tensor, cache: torch.Tensor,
        truncated_context_size: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, c, D]; conv_mask [N, 1, c + 2*lorder]; cache [D, lorder].

        Returns (y [N, c, D], new_cache [D, lorder]); the new cache is columns
        [trunc, trunc + lorder) of the cache-prefixed stream
        (reference convolution.py:229-230).
        """
        n, c, d = x.shape
        lo = self.lorder
        h = F.glu(F.linear(x, self.pointwise_conv1.weight[:, :, 0],
                           self.pointwise_conv1.bias), dim=-1)            # [N, c, D]
        flat = torch.cat([cache.t().to(h.dtype), h.reshape(n * c, d)], dim=0)
        new_cache = flat[truncated_context_size:truncated_context_size + lo].t().contiguous()
        flat = F.pad(flat, (0, 0, 0, lo))
        win = flat.unfold(0, c + 2 * lo, c)                                # [N, D, c+2l]
        win = win.masked_fill(~conv_mask, 0.0)
        y = F.conv1d(win, self.depthwise_conv.weight, self.depthwise_conv.bias,
                     groups=d)                                             # [N, D, c]
        if self.use_layer_norm:
            y = self.norm(y.transpose(1, 2))
        else:
            y = self.norm(y).transpose(1, 2)
        y = F.linear(F.silu(y), self.pointwise_conv2.weight[:, :, 0], self.pointwise_conv2.bias)
        y = y.masked_fill(~conv_mask[:, 0, lo:-lo, None], 0.0)
        return y, new_cache
