"""Chunk-aware Conformer convolution module (counterpart of
``chunkformer_tpu/nn/convolution.py``): pointwise-GLU -> depthwise conv ->
norm -> swish -> pointwise, in two modes:

- ``parallel_chunk`` (:128, reference convolution.py:194-255): depthwise conv
  over overlapping windows of the flat stream (cache prefix, lorder zero
  columns at the end), with the conv mask applied before the depthwise conv
  and to the output.
- ``full`` (``conv_full`` :86): full context, or with ``chunk_size > 0``
  (dynamic_conv training, reference convolution.py:150-180) each chunk sees
  real left context and zero right padding. In training the batch norm uses
  batch statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm_train


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
        y, _ = self._post(y, train=False)
        y = y.masked_fill(~conv_mask[:, 0, lo:-lo, None], 0.0)
        return y, new_cache

    def _post(self, y: torch.Tensor, train: bool):
        """norm -> swish -> pointwise2 over y [N, C, T]; returns ([N, T, C], new BN stats)."""
        stats = None
        if self.use_layer_norm:
            y = self.norm(y.transpose(1, 2))
        elif train:
            y, stats = batch_norm_train(self.norm, y)
            y = y.transpose(1, 2)
        else:
            n = self.norm
            y = F.batch_norm(y, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0,
                             n.eps).transpose(1, 2)
        y = F.linear(F.silu(y), self.pointwise_conv2.weight[:, :, 0], self.pointwise_conv2.bias)
        return y, stats

    def full(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor], chunk_size: int = 0,
             causal: bool = False, train: bool = False
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """x [B, T, D]; pad_mask [B, T] (True = valid). Returns (y [B, T, D],
        new batch-norm running statistics, or None)."""
        b, t, d = x.shape
        k = self.depthwise_conv.kernel_size[0]
        lorder = k - 1 if causal else (k - 1) // 2
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        h = F.glu(F.linear(x, self.pointwise_conv1.weight[:, :, 0],
                           self.pointwise_conv1.bias), dim=-1).transpose(1, 2)  # [B, C, T]
        if chunk_size > 0:
            c = chunk_size
            n = -(-t // c)
            # each chunk sees lorder real left frames and k - 1 - lorder zero
            # right frames: (k - 1) // 2 of them, or none when causal
            win = F.pad(h, (lorder, n * c - t)).unfold(2, lorder + c, c)     # [B, C, n, l+c]
            win = F.pad(win.permute(0, 2, 1, 3).reshape(b * n, d, lorder + c),
                        (0, k - 1 - lorder))
            y = F.conv1d(win, self.depthwise_conv.weight, self.depthwise_conv.bias, groups=d)
            y = y.view(b, n, d, c).permute(0, 2, 1, 3).reshape(b, d, n * c)[:, :, :t]
        else:
            h = F.pad(h, (lorder, 0) if causal else (lorder, lorder))
            y = F.conv1d(h, self.depthwise_conv.weight, self.depthwise_conv.bias, groups=d)
        y, stats = self._post(y, train)
        if pad_mask is not None:
            y = y.masked_fill(~pad_mask[:, :, None], 0.0)
        return y, stats
