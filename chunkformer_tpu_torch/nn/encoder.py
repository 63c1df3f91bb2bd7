"""ChunkFormer encoder, masked-batch parallel-chunk mode (counterpart of
``chunkformer_tpu/nn/encoder.py``: ``_embed`` :85-107, ``init_caches`` :218,
``encoder_parallel_chunk`` :234).

Reference: chunkformer/modules/encoder.py:503-681. A Python loop over the
layers takes the place of ``lax.scan``; the per-layer KV and conv caches are
stacked as [n_layers, L, H, 2dk] and [n_layers, D, lorder].
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..config import EncoderConfig
from ..ops.chunk import parallel_chunk_conv_mask
from .embedding import rel_pos_slice
from .encoder_layer import ChunkFormerEncoderLayer
from .layers import make_norm
from .subsampling import DepthwiseConvSubsampling


class GlobalCMVN(nn.Module):
    """(x - mean) * istd with the global stats as buffers (reference: modules/cmvn.py)."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("istd", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * self.istd


class ChunkFormerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, cmvn: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        self.global_cmvn = GlobalCMVN(cfg.input_size) if cmvn else None
        self.embed = DepthwiseConvSubsampling(cfg.input_size, d, d)
        self.encoders = nn.ModuleList([
            ChunkFormerEncoderLayer(d, cfg.attention_heads, cfg.linear_units,
                                    cfg.cnn_module_kernel, cfg.cnn_module_norm,
                                    cfg.macaron_style, cfg.use_cnn_module,
                                    cfg.activation_type, cfg.normalize_before, cfg.norm_eps)
            for _ in range(cfg.num_blocks)])
        self.after_norm = make_norm(d, cfg.layer_norm_type, cfg.norm_eps)

    def embed_features(self, x: torch.Tensor) -> torch.Tensor:
        """cmvn -> subsampling conv stack -> xscale: [N, T, feat] -> [N, T', D]."""
        if self.global_cmvn is not None:
            x = self.global_cmvn(x)
        return self.embed(x) * math.sqrt(self.cfg.output_size)

    def init_caches(self, left_context_size: int, dtype: torch.dtype,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero caches: att [n_layers, L, H, 2dk], cnn [n_layers, D, lorder]."""
        cfg = self.cfg
        att = torch.zeros((cfg.num_blocks, left_context_size, cfg.attention_heads,
                           2 * cfg.head_dim), dtype=dtype, device=device)
        cnn = torch.zeros((cfg.num_blocks, cfg.output_size, cfg.conv_lorder),
                          dtype=dtype, device=device)
        return att, cnn

    def parallel_chunk(
        self, xs: torch.Tensor, chunk_idx: torch.Tensor, offsets: torch.Tensor,
        max_lens: torch.Tensor, chunk_size: int, left_context_size: int,
        right_context_size: int, att_cache: torch.Tensor, cnn_cache: torch.Tensor,
        truncated_context_size: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked-batch inference over packed chunk rows xs [N, size, feat].

        chunk_idx / offsets / max_lens are int32 [N] on the device of xs.
        Returns (out [N, c, D], new_att_cache, new_cnn_cache).
        """
        cfg = self.cfg
        c, L, R = chunk_size, left_context_size, right_context_size
        x = self.embed_features(xs)
        pos_emb = torch.from_numpy(rel_pos_slice(cfg.output_size, c, L, R, cfg.max_pos_len))
        pos_emb = pos_emb.to(device=x.device, dtype=x.dtype)
        conv_mask = parallel_chunk_conv_mask(chunk_idx, offsets, max_lens, c,
                                             cfg.conv_lorder, R)
        new_att, new_cnn = [], []
        for i, layer in enumerate(self.encoders):
            x, a, k = layer.parallel_chunk(x, pos_emb, chunk_idx, offsets, max_lens, conv_mask,
                                           att_cache[i], cnn_cache[i], L, R,
                                           truncated_context_size)
            new_att.append(a)
            new_cnn.append(k)
        if cfg.normalize_before and cfg.final_norm:
            x = self.after_norm(x)
        return x, torch.stack(new_att), torch.stack(new_cnn)
