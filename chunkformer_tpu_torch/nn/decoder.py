"""AED transformer decoder, left-to-right and right-to-left (counterpart of
``chunkformer_tpu/nn/decoder.py``: ``mha`` :38, ``_side_forward``,
``decoder_forward`` :157).

Reference: chunkformer/modules/decoder.py:35-515, decoder_layer.py:24-149:
token embedding * sqrt(d) + absolute sinusoid PE, pre-norm blocks of causal
self-attention -> cross-attention -> ReLU FFN, final norm and output
projection. Parameter names are the reference's (``chunkformer_tpu/export.py:99-124``):
``decoder.left_decoder.*`` and ``decoder.right_decoder.*``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import DecoderConfig
from ..ops.chunk_attention import masked_softmax
from ..ops.masks import make_non_pad_mask, subsequent_mask
from .embedding import abs_pos_table
from .layers import PositionwiseFeedForward, dropout


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product MHA (reference attention.py:10-218)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, mask, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, T1, D], key and value [B, T2, D], mask [B, 1 | T1, T2] (True = valid)."""
        b, t1, d = query.shape
        h = self.heads
        q = self.linear_q(query).view(b, t1, h, d // h)
        k = self.linear_k(key).view(b, key.shape[1], h, d // h)
        v = self.linear_v(value).view(b, value.shape[1], h, d // h)
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(d // h)
        attn = dropout(masked_softmax(scores, mask[:, None]), drop_rate, generator)
        out = torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)
        return self.linear_out(out.reshape(b, t1, d))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, linear_units: int):
        super().__init__()
        self.self_attn = MultiHeadedAttention(d_model, heads)
        self.src_attn = MultiHeadedAttention(d_model, heads)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units, "relu")
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, x, tgt_mask, memory, memory_mask, cfg: DecoderConfig,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        rate = cfg.dropout_rate if generator is not None else 0.0
        h = self.norm1(x)
        h = self.self_attn(h, h, h, tgt_mask, cfg.self_attention_dropout_rate
                           if generator is not None else 0.0, generator)
        x = x + dropout(h, rate, generator)
        h = self.src_attn(self.norm2(x), memory, memory, memory_mask,
                          cfg.src_attention_dropout_rate if generator is not None else 0.0,
                          generator)
        x = x + dropout(h, rate, generator)
        h = self.feed_forward(self.norm3(x), rate, generator)
        return x + dropout(h, rate, generator)


class _Embed(nn.Module):
    """Token embedding; index 0 of the reference's Sequential(Embedding, PE)."""

    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.add_module("0", nn.Embedding(vocab_size, d_model))

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = getattr(self, "0")
        d = emb.embedding_dim
        pe = torch.from_numpy(abs_pos_table(d)[:tokens.shape[1]]).to(tokens.device)
        return (emb(tokens) * math.sqrt(d) + pe).to(dtype)


class TransformerDecoder(nn.Module):
    """One decoder stack (``_side_forward``)."""

    def __init__(self, cfg: DecoderConfig, vocab_size: int, d_model: int, num_blocks: int):
        super().__init__()
        self.cfg = cfg
        self.embed = _Embed(vocab_size, d_model)
        self.decoders = nn.ModuleList([DecoderLayer(d_model, cfg.attention_heads,
                                                    cfg.linear_units)
                                       for _ in range(num_blocks)])
        self.after_norm = nn.LayerNorm(d_model)
        self.output_layer = nn.Linear(d_model, vocab_size) if cfg.use_output_layer else None

    def forward(self, tokens, tgt_mask, memory, memory_mask,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, U]; tgt_mask [B, U, U]; memory [B, T, D]; memory_mask [B, T]."""
        x = self.embed(tokens, memory.dtype)
        mem_mask = memory_mask[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_mask, self.cfg, generator)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        if self.output_layer is not None:
            x = self.output_layer(x)
        return x


class BiTransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, vocab_size: int, d_model: int):
        super().__init__()
        self.left_decoder = TransformerDecoder(cfg, vocab_size, d_model, cfg.num_blocks)
        self.right_decoder = None
        if cfg.decoder_type == "bitransformer" and cfg.r_num_blocks > 0:
            self.right_decoder = TransformerDecoder(cfg, vocab_size, d_model, cfg.r_num_blocks)

    def forward(self, memory, memory_mask, ys_in, ys_in_lens, r_ys_in=None,
                reverse_weight: float = 0.0, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``decoder_forward``: (l_logits [B, U, V], r_logits or None)
        (reference decoder.py:173-252, 414-470)."""
        u = ys_in.shape[1]
        pad = make_non_pad_mask(ys_in_lens, u)
        tgt_mask = pad[:, None, :] & subsequent_mask(u, ys_in.device)[None]
        l_logits = self.left_decoder(ys_in, tgt_mask, memory, memory_mask, generator)
        r_logits = None
        if r_ys_in is not None and self.right_decoder is not None and reverse_weight > 0.0:
            r_logits = self.right_decoder(r_ys_in, tgt_mask, memory, memory_mask, generator)
        return l_logits, r_logits
