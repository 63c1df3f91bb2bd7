"""Chunk-aware Conformer convolution module (counterpart of
``chunkformer_tpu/nn/convolution.py``): pointwise-GLU -> depthwise conv ->
norm -> swish -> pointwise, in three modes:

- ``parallel_chunk`` (:128, reference convolution.py:194-255): depthwise conv
  over overlapping windows of the flat stream (cache prefix, lorder zero
  columns at the end), with the conv mask applied before the depthwise conv
  and to the output.
- ``full`` (``conv_full`` :86): full context, or with ``chunk_size > 0``
  (dynamic_conv training, reference convolution.py:150-180) each chunk sees
  real left context and zero right padding. In training the batch norm uses
  batch statistics.
- ``streaming`` (``conv_streaming`` :158): one incremental step over c + R
  frames behind a [B, D, lorder] cache, each chunk with zero right padding
  as in ``full``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import row_shard
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
        # the data axis's process group under data parallelism
        # (``parallel/data_group.py``): train-mode batch statistics over it
        self.data_group = None

    def parallel_chunk(
        self, x: torch.Tensor, conv_mask: torch.Tensor, cache: torch.Tensor,
        truncated_context_size: int, group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, c, D]; conv_mask [N, 1, c + 2*lorder]; cache [D, lorder].

        Returns (y [N, c, D], new_cache [D, lorder]); the new cache is columns
        [trunc, trunc + lorder) of the cache-prefixed stream
        (reference convolution.py:229-230). With ``group`` x holds this
        rank's block of rows, and the lorder frames on each side of it come
        from the neighbouring ranks as in the attention's
        ``parallel_chunk``.
        """
        n, c, d = x.shape
        lo = self.lorder
        h = F.glu(F.linear(x, self.pointwise_conv1.weight[:, :, 0],
                           self.pointwise_conv1.bias), dim=-1)            # [N, c, D]
        if group is None:
            flat = torch.cat([cache.t().to(h.dtype), h.reshape(n * c, d)], dim=0)
            new_cache = flat[truncated_context_size:truncated_context_size + lo].t().contiguous()
            flat = F.pad(flat, (0, 0, 0, lo))
        else:
            flat, kept = row_shard.exchange(h.reshape(n * c, d), cache.t().to(h.dtype), lo,
                                            group, (truncated_context_size, lo))
            new_cache = kept.t().contiguous()
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
            y, stats = batch_norm_train(self.norm, y, group=self.data_group)
            y = y.transpose(1, 2)
        else:
            n = self.norm
            y = F.batch_norm(y, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0,
                             n.eps).transpose(1, 2)
        y = F.linear(F.silu(y), self.pointwise_conv2.weight[:, :, 0], self.pointwise_conv2.bias)
        return y, stats

    def _chunk_depthwise(self, h: torch.Tensor, chunk_size: int, lorder: int) -> torch.Tensor:
        """Depthwise conv of h [B, C, lorder + T] (lorder frames of left
        context, then T frames) chunk by chunk: each chunk of c frames sees
        its lorder real left frames and k - 1 - lorder zero right frames
        ((k - 1) // 2 of them, or none when causal). Returns [B, C, T]."""
        b, d, t = h.shape
        t -= lorder
        c = chunk_size
        k = self.depthwise_conv.kernel_size[0]
        n = -(-t // c)
        win = F.pad(h, (0, n * c - t)).unfold(2, lorder + c, c)              # [B, C, n, l+c]
        win = F.pad(win.permute(0, 2, 1, 3).reshape(b * n, d, lorder + c), (0, k - 1 - lorder))
        y = F.conv1d(win, self.depthwise_conv.weight, self.depthwise_conv.bias, groups=d)
        return y.view(b, n, d, c).permute(0, 2, 1, 3).reshape(b, d, n * c)[:, :, :t]

    def streaming(self, x: torch.Tensor, cache: torch.Tensor, chunk_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One streaming step (``conv_streaming``): x [B, T, D] with T =
        chunk + lookahead frames; cache [B, D, lorder] holds the last lorder
        frames of the previous steps' pointwise-GLU stream. Each c-frame
        window sees its real left context and zero right padding. Returns
        (y [B, T, D], the stream [B, D, lorder + T]); the caller slices the
        next cache from the stream."""
        t = x.shape[1]
        h = F.glu(F.linear(x, self.pointwise_conv1.weight[:, :, 0],
                           self.pointwise_conv1.bias), dim=-1).transpose(1, 2)  # [B, C, T]
        stream = torch.cat([cache.to(h.dtype), h], dim=2)
        y = self._chunk_depthwise(stream, chunk_size if chunk_size > 0 else t, self.lorder)
        y, _ = self._post(y, train=False)
        return y, stream

    def full(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor], chunk_size: int = 0,
             causal: bool = False, train: bool = False
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """x [B, T, D]; pad_mask [B, T] (True = valid). Returns (y [B, T, D],
        new batch-norm running statistics, or None)."""
        d = x.shape[2]
        k = self.depthwise_conv.kernel_size[0]
        lorder = k - 1 if causal else (k - 1) // 2
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        h = F.glu(F.linear(x, self.pointwise_conv1.weight[:, :, 0],
                           self.pointwise_conv1.bias), dim=-1).transpose(1, 2)  # [B, C, T]
        if chunk_size > 0:
            y = self._chunk_depthwise(F.pad(h, (lorder, 0)), chunk_size, lorder)
        else:
            h = F.pad(h, (lorder, 0) if causal else (lorder, lorder))
            y = F.conv1d(h, self.depthwise_conv.weight, self.depthwise_conv.bias, groups=d)
        y, stats = self._post(y, train)
        if pad_mask is not None:
            y = y.masked_fill(~pad_mask[:, :, None], 0.0)
        return y, stats
