"""ChunkFormer encoder layer (Conformer block), counterpart of
``chunkformer_tpu/nn/encoder_layer.py:41 encoder_layer_apply``.

Macaron-FFN(1/2) -> MHA -> Conv -> FFN(1/2) -> final norm
(reference: chunkformer/modules/encoder_layer.py:9-248). ``parallel_chunk``
serves masked-batch inference; ``streaming`` one incremental step;
``forward_train`` the full and limited-context forward, with its dropouts.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .attention import RelPositionMultiHeadedAttention
from .convolution import ConvolutionModule
from .layers import PositionwiseFeedForward, dropout


class ChunkFormerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, linear_units: int, cnn_kernel: int = 15,
                 cnn_norm: str = "batch_norm", macaron: bool = True, use_cnn: bool = True,
                 act: str = "swish", normalize_before: bool = True, norm_eps: float = 1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = RelPositionMultiHeadedAttention(d_model, heads)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units, act)
        self.norm_ff = nn.LayerNorm(d_model, eps=norm_eps)
        self.norm_mha = nn.LayerNorm(d_model, eps=norm_eps)
        self.feed_forward_macaron = None
        if macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(d_model, linear_units, act)
            self.norm_ff_macaron = nn.LayerNorm(d_model, eps=norm_eps)
        self.conv_module = None
        if use_cnn:
            self.conv_module = ConvolutionModule(d_model, cnn_kernel, cnn_norm)
            self.norm_conv = nn.LayerNorm(d_model, eps=norm_eps)
            self.norm_final = nn.LayerNorm(d_model, eps=norm_eps)

    def _residual(self, x, norm, fn, scale=1.0):
        """Pre-norm x + scale*y with (y, extra) = fn(norm(x)), or post-norm
        norm(x + scale*y) with fn(x). Returns (x, extra)."""
        y, extra = fn(norm(x) if self.normalize_before else x)
        x = x + scale * y
        return (x if self.normalize_before else norm(x)), extra

    def parallel_chunk(
        self, x: torch.Tensor, pos_emb: torch.Tensor, chunk_idx: torch.Tensor,
        offsets: torch.Tensor, max_lens: torch.Tensor, conv_mask: torch.Tensor,
        att_cache: torch.Tensor, cnn_cache: torch.Tensor, left: int, right: int,
        truncated_context_size: int, group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One block over chunk rows x [N, c, D]; returns (x, new_att_cache,
        new_cnn_cache). With ``group`` x is this rank's block of the rows
        (``parallel/row_shard.py``)."""
        ff_scale = 0.5 if self.feed_forward_macaron is not None else 1.0
        if self.feed_forward_macaron is not None:
            x, _ = self._residual(x, self.norm_ff_macaron,
                                  lambda h: (self.feed_forward_macaron(h), None), ff_scale)

        x, new_att = self._residual(
            x, self.norm_mha, lambda h: self.self_attn.parallel_chunk(
                h, pos_emb, chunk_idx, offsets, max_lens, att_cache, left, right,
                truncated_context_size, group))

        new_cnn = cnn_cache
        if self.conv_module is not None:
            x, new_cnn = self._residual(
                x, self.norm_conv, lambda h: self.conv_module.parallel_chunk(
                    h, conv_mask, cnn_cache, truncated_context_size, group))

        x, _ = self._residual(x, self.norm_ff, lambda h: (self.feed_forward(h), None), ff_scale)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, new_att, new_cnn

    def streaming(
        self, x: torch.Tensor, pos_emb: torch.Tensor, mask: torch.Tensor,
        att_cache: torch.Tensor, cnn_cache: torch.Tensor, chunk_size: int,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """One block of a streaming step over x [B, c + R, D]; returns (x,
        kv_full [B, L + c + R, H, 2dk], the conv stream [B, D, lorder + c + R]
        or None without a conv module). The caller slices the caches."""
        ff_scale = 0.5 if self.feed_forward_macaron is not None else 1.0
        if self.feed_forward_macaron is not None:
            x, _ = self._residual(x, self.norm_ff_macaron,
                                  lambda h: (self.feed_forward_macaron(h), None), ff_scale)
        x, kv_full = self._residual(
            x, self.norm_mha, lambda h: self.self_attn.streaming(h, pos_emb, mask, att_cache))
        stream = None
        if self.conv_module is not None:
            x, stream = self._residual(
                x, self.norm_conv, lambda h: self.conv_module.streaming(h, cnn_cache, chunk_size))
        x, _ = self._residual(x, self.norm_ff, lambda h: (self.feed_forward(h), None), ff_scale)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, kv_full, stream

    def forward_train(
        self, x: torch.Tensor, attn_fn: Callable[[torch.Tensor], torch.Tensor],
        conv_fn: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, object]]],
        drop_rate: float = 0.0, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One block over x [B, T, D] (``encoder_layer_apply`` with train=True):
        attn_fn(h) -> out, conv_fn(h) -> (out, new BN stats). Dropout masks
        come from ``generator`` in a fixed order (none when it is None)."""
        ff_scale = 0.5 if self.feed_forward_macaron is not None else 1.0

        def drop(y):
            return dropout(y, drop_rate, generator)

        if self.feed_forward_macaron is not None:
            x, _ = self._residual(x, self.norm_ff_macaron, lambda h: (drop(
                self.feed_forward_macaron(h, drop_rate, generator)), None), ff_scale)
        x, _ = self._residual(x, self.norm_mha, lambda h: (drop(attn_fn(h)), None))
        if self.conv_module is not None:
            x, _ = self._residual(x, self.norm_conv, lambda h: (drop(conv_fn(h)[0]), None))
        x, _ = self._residual(x, self.norm_ff, lambda h: (drop(
            self.feed_forward(h, drop_rate, generator)), None), ff_scale)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x
