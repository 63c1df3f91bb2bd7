"""Chunked relative-position multi-head attention, parallel-chunk mode
(counterpart of ``chunkformer_tpu/nn/attention.py:235 attention_parallel_chunk``
and ``:269 attention_parallel_chunk_pallas``).

Reference: chunkformer/modules/attention.py:420-505. The K/V projections of
all chunk rows form one flat stream behind the L-row cache and ahead of R
zero rows; chunk row i attends over stream rows [i*c, i*c + L + c + R),
which ``ops.chunk_attention`` reads in place (no unfold).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..ops.chunk_attention import chunk_attention


class RelPositionMultiHeadedAttention(nn.Module):
    """Parameter names as the reference ChunkAttentionWithRelativeRightContext."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.d_k = d_model // heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        bound = math.sqrt(6.0 / (heads + self.d_k))
        self.pos_bias_u = nn.Parameter(torch.empty(heads, self.d_k).uniform_(-bound, bound))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, self.d_k).uniform_(-bound, bound))

    def parallel_chunk(
        self, x: torch.Tensor, pos_emb: torch.Tensor, chunk_idx: torch.Tensor,
        offsets: torch.Tensor, max_lens: torch.Tensor, cache: torch.Tensor,
        left: int, right: int, truncated_context_size: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, c, D] chunk rows; pos_emb [2c-1+L+R, D]; cache [L, H, 2dk].

        Returns (out [N, c, D], new_cache [L, H, 2dk]); the new cache is rows
        [trunc, trunc + L) of the cache-prefixed stream (reference
        attention.py:467).
        """
        n, c, d = x.shape
        h, dk = self.heads, self.d_k
        q = self.linear_q(x).view(n, c, h, dk)
        kv = torch.cat([self.linear_k(x).view(n * c, h, dk),
                        self.linear_v(x).view(n * c, h, dk)], dim=-1)
        stream = torch.cat([cache.to(kv.dtype), kv, kv.new_zeros(right, h, 2 * dk)], dim=0)
        new_cache = stream[truncated_context_size:truncated_context_size + left].clone()
        p = self.linear_pos(pos_emb.to(x.dtype)).view(-1, h, dk)
        ctx = chunk_attention(q, stream, p, self.pos_bias_u, self.pos_bias_v,
                              chunk_idx, offsets, max_lens, chunk=c, left=left, right=right)
        return self.linear_out(ctx.reshape(n, c, d)), new_cache
