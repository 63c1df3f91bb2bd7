"""Depthwise-conv 2D subsampling frontend, 8x (counterpart of
``chunkformer_tpu/nn/subsampling.py:129 subsampling_forward``).

Reference: chunkformer/modules/subsampling.py:10-311. Three stride-2 valid
3x3 conv stages over (time, freq) — a full conv, then twice depthwise +
pointwise — each followed by ReLU, then a linear projection of the
channel-major flattened (channel, freq) axes: input index c*F' + f.
Consumes 15 frames of context. ``conv`` keeps the reference's Sequential
indices (0 conv, 2 dw, 3 pw, 5 dw, 6 pw) so state-dict names match.
"""

from __future__ import annotations

import torch
from torch import nn


def freq_out_dim(feat_in: int, sampling_num: int = 3) -> int:
    f = feat_in
    for _ in range(sampling_num):
        f = (f - 3) // 2 + 1
    return f


class DepthwiseConvSubsampling(nn.Module):
    def __init__(self, feat_in: int, feat_out: int, channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, channels, 3, 2), nn.ReLU(),
            nn.Conv2d(channels, channels, 3, 2, groups=channels),
            nn.Conv2d(channels, channels, 1), nn.ReLU(),
            nn.Conv2d(channels, channels, 3, 2, groups=channels),
            nn.Conv2d(channels, channels, 1), nn.ReLU(),
        )
        self.out = nn.Linear(channels * freq_out_dim(feat_in), feat_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, T, F] -> [N, T', D]."""
        y = self.conv(x[:, None])                       # [N, C, T', F']
        n, c, t, f = y.shape
        return self.out(y.transpose(1, 2).reshape(n, t, c * f))
