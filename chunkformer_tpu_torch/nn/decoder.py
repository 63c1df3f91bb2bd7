"""AED transformer decoder, left-to-right and right-to-left (counterpart of
``chunkformer_tpu/nn/decoder.py``: ``mha`` :38, ``_side_forward``,
``decoder_forward`` :157, and the one-token search step ``decoder_step``
:181 with its fixed-size cache ``init_decoder_cache`` :248).

Reference: chunkformer/modules/decoder.py:35-515, decoder_layer.py:24-149:
token embedding * sqrt(d) + absolute sinusoid PE, pre-norm blocks of causal
self-attention -> cross-attention -> ReLU FFN, final norm and output
projection. Parameter names are the reference's (``chunkformer_tpu/export.py:99-124``):
``decoder.left_decoder.*`` and ``decoder.right_decoder.*``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import DecoderConfig
from ..ops.chunk_attention import masked_softmax
from ..ops.masks import make_non_pad_mask, subsequent_mask
from ..parallel.tensor_parallel import copy_to_tp, row_parallel_linear
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
        self.tp = None  # this rank's place under tensor parallelism (slices of the heads)

    def forward(self, query, key, value, mask, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, T1, D], key and value [B, T2, D], mask [B, 1 | T1, T2] (True = valid)."""
        return self.attend(query, self.linear_k(copy_to_tp(key, self.tp)),
                           self.linear_v(copy_to_tp(value, self.tp)), mask, drop_rate, generator)

    def attend(self, query, k, v, mask, drop_rate: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``forward`` from keys and values already projected ([B, T2, D])."""
        b, t1, d = query.shape
        d_k = d // self.heads
        q = self.linear_q(copy_to_tp(query, self.tp)).view(b, t1, -1, d_k)
        h = q.shape[2]  # this rank's heads
        k = k.view(b, k.shape[1], h, d_k)
        v = v.view(b, v.shape[1], h, d_k)
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(d_k)
        shard = None if self.tp is None else (1, *self.tp.span(h))
        attn = dropout(masked_softmax(scores, mask[:, None]), drop_rate, generator, shard)
        out = torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)
        return row_parallel_linear(self.linear_out, out.reshape(b, t1, h * d_k), self.tp)


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


def init_decoder_cache(n_layers: int, batch: int, u_max: int, d_model: int,
                       dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Zero self-attention caches of the left decoder: k and v, each
    [n_layers, B, U_max, D] (post-projection states)."""
    shape = (n_layers, batch, u_max, d_model)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def memory_projections(decoder: BiTransformerDecoder, memory: torch.Tensor
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The left decoder's cross-attention keys and values of ``memory``, one
    (k, v) pair [B, T, D] a layer: the same at every step of a search."""
    return [(layer.src_attn.linear_k(memory), layer.src_attn.linear_v(memory))
            for layer in decoder.left_decoder.decoders]


def decoder_step(decoder: BiTransformerDecoder, memory: torch.Tensor,
                 memory_mask: torch.Tensor, tokens: torch.Tensor, pos: int,
                 cache: Dict[str, torch.Tensor],
                 memory_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
                 ) -> torch.Tensor:
    """One token of the left decoder with a fixed-size self-attention cache.

    tokens [B] at position ``pos``; memory [B, T, D], memory_mask [B, T]
    (True = valid). Writes this position's k and v of every layer into
    ``cache`` in place (at ``pos``; the JAX function returns a new cache
    instead) and returns f32 log-probs [B, V]. Positions past ``pos`` are
    masked out: ``valid = arange(U_max) <= pos``. ``memory_kv`` from
    ``memory_projections`` saves projecting the memory again at every step
    (the JAX step projects it each time; the values are the same).
    """
    if memory_kv is None:
        memory_kv = memory_projections(decoder, memory)
    side = decoder.left_decoder
    emb = getattr(side.embed, "0")
    d = emb.embedding_dim
    dtype = memory.dtype
    pe = torch.from_numpy(abs_pos_table(d)[pos:pos + 1]).to(device=memory.device, dtype=dtype)
    x = (emb.weight.to(dtype)[tokens] * math.sqrt(d) + pe)[:, None]    # [B, 1, D]
    mem_mask = memory_mask[:, None, :]
    valid = (torch.arange(cache["k"].shape[2], device=memory.device) <= pos)[None, None, :]
    for i, layer in enumerate(side.decoders):
        sa = layer.self_attn
        h = layer.norm1(x)
        cache["k"][i, :, pos] = sa.linear_k(h)[:, 0]
        cache["v"][i, :, pos] = sa.linear_v(h)[:, 0]
        x = x + sa.attend(h, cache["k"][i], cache["v"][i], valid)
        x = x + layer.src_attn.attend(layer.norm2(x), *memory_kv[i], mem_mask)
        x = x + layer.feed_forward(layer.norm3(x))
    if side.cfg.normalize_before:
        x = side.after_norm(x)
    if side.output_layer is not None:
        x = side.output_layer(x)
    return torch.log_softmax(x[:, 0].float(), dim=-1)
