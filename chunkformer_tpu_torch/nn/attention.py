"""Chunked relative-position multi-head attention (counterpart of
``chunkformer_tpu/nn/attention.py``), in four modes:

- ``parallel_chunk`` (:235, :269): masked-batch inference over packed chunk
  rows (reference attention.py:420-505). The K/V projections of all chunk
  rows form one flat stream behind the L-row cache and ahead of R zero rows;
  chunk row i attends over stream rows [i*c, i*c + L + c + R), which
  ``ops.chunk_attention`` reads in place (no unfold).
- ``full`` (:93): full-context training and evaluation.
- ``streaming`` (``attention_streaming`` :368): one incremental step of
  c + R query frames over an L-row cache, in plain PyTorch as in JAX (plain
  XLA there; the packed-row decode kernel does not take this layout).
- limited-context training: ``chunked_train`` (:142) builds the operands of
  the training kernels (``ops.chunk_attention_train``) per utterance, and
  ``attention_chunked_train`` (:103, unfold + rel_shift + masked softmax) is
  their plain oracle.

Attention-weight dropout in the chunked modes is the counter-based mask of
``ops.chunk_attention_train`` (seeded per layer), so the kernel and the
oracle drop the same weights; in full mode it draws from a generator.

Under tensor parallelism (``tp``, set by
``parallel.tensor_parallel.apply_tensor_parallel``) the module holds a
slice of the heads: the local head count comes from the weights, the
training attention hashes its dropout by global head, full-mode dropout
draws the full-width mask and keeps its heads, and the output projection
sums over the group.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chunk_attention import chunk_attention, masked_softmax
from ..ops.chunk_attention_train import chunk_train_attention, window_keep_mask
from ..ops.relshift import rel_shift
from ..parallel import row_shard
from ..parallel.tensor_parallel import copy_to_tp, row_parallel_linear
from .layers import dropout


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
        self.tp = None

    def _head_span(self, local: int) -> Tuple[int, int]:
        """(first global head, global heads) of ``local`` heads; (0, 0) on one process."""
        return (0, 0) if self.tp is None else self.tp.span(local)

    def parallel_chunk(
        self, x: torch.Tensor, pos_emb: torch.Tensor, chunk_idx: torch.Tensor,
        offsets: torch.Tensor, max_lens: torch.Tensor, cache: torch.Tensor,
        left: int, right: int, truncated_context_size: int, group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, c, D] chunk rows; pos_emb [2c-1+L+R, D]; cache [L, H, 2dk].

        Returns (out [N, c, D], new_cache [L, H, 2dk]); the new cache is rows
        [trunc, trunc + L) of the cache-prefixed stream (reference
        attention.py:467). With ``group`` (a process group) x holds this
        rank's block of the batch's rows (``parallel/row_shard.py``): the
        K/V stream's L rows before the block and R rows after it come from
        the neighbouring ranks (the cache before the first row, zeros after
        the last), and the new cache, from the global stream, is the same on
        every rank.
        """
        n, c, d = x.shape
        h, dk = self.heads, self.d_k
        q = self.linear_q(x).view(n, c, h, dk)
        kv = torch.cat([self.linear_k(x).view(n * c, h, dk),
                        self.linear_v(x).view(n * c, h, dk)], dim=-1)
        if group is None:
            stream = torch.cat([cache.to(kv.dtype), kv, kv.new_zeros(right, h, 2 * dk)], dim=0)
            new_cache = stream[truncated_context_size:truncated_context_size + left].clone()
        else:
            stream, new_cache = row_shard.exchange(kv, cache.to(kv.dtype), right, group,
                                                   (truncated_context_size, left))
        p = self.linear_pos(pos_emb.to(x.dtype)).view(-1, h, dk)
        ctx = chunk_attention(q, stream, p, self.pos_bias_u, self.pos_bias_v,
                              chunk_idx, offsets, max_lens, chunk=c, left=left, right=right)
        return self.linear_out(ctx.reshape(n, c, d)), new_cache

    def _heads(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        y = linear(x)
        return y.view(*y.shape[:-1], -1, self.d_k)

    def rel_attention_core(self, q, k, v, pos_emb, mask, left: int, right: int,
                           drop=None) -> torch.Tensor:
        """Transformer-XL scores over head-split q [N, T1, H, dk], k and v
        [N, T2, H, dk] (T2 = T1 + L + R), pos_emb [2*T1 - 1 + L + R, D], mask
        [N, 1 | T1, T2] (True = valid); ``drop`` maps the weights
        [N, H, T1, T2] to their dropped version. Returns [N, T1, D]
        (``chunkformer_tpu/nn/attention.py:56``)."""
        n, t1, h, d_k = q.shape
        p = self.linear_pos(pos_emb.to(q.dtype)).view(-1, h, d_k)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)
        ac = torch.einsum("nthd,nshd->nhts", q_u, k).float()
        bd = torch.einsum("nthd,phd->nhtp", q_v, p).float()
        scores = (ac + rel_shift(bd, left, right)) / math.sqrt(d_k)
        attn = masked_softmax(scores, mask[:, None])
        if drop is not None:
            attn = drop(attn)
        out = torch.einsum("nhts,nshd->nthd", attn.to(v.dtype), v)
        return row_parallel_linear(self.linear_out, out.reshape(n, t1, h * d_k), self.tp)

    def streaming(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: torch.Tensor,
                  cache: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One streaming step (``attention_streaming``): x [B, T1, D] attends
        over the cache [B, L, H, 2dk] and its own keys; pos_emb
        [2*T1 - 1 + L, D]; mask [B, 1, L + T1]. Returns (out [B, T1, D],
        kv_full [B, L + T1, H, 2dk]); the caller slices the next cache."""
        q, k, v = (self._heads(lin, x) for lin in (self.linear_q, self.linear_k, self.linear_v))
        kv_full = torch.cat([cache.to(k.dtype), torch.cat([k, v], dim=-1)], dim=1)
        k, v = kv_full.split(self.d_k, dim=-1)
        return self.rel_attention_core(q, k, v, pos_emb, mask, cache.shape[1], 0), kv_full

    def full(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: torch.Tensor,
             drop_rate: float = 0.0, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Full-context self attention: x [B, T, D], pos_emb [2T - 1, D], mask [B, 1, T]."""
        x = copy_to_tp(x, self.tp)
        q, k, v = (self._heads(lin, x) for lin in (self.linear_q, self.linear_k, self.linear_v))
        shard = None if self.tp is None else (1, *self._head_span(q.shape[2]))
        return self.rel_attention_core(q, k, v, pos_emb, mask, 0, 0,
                                       lambda a: dropout(a, drop_rate, generator, shard))

    def attention_chunked_train(self, x: torch.Tensor, pos_emb: torch.Tensor,
                                lens: torch.Tensor, chunk: int, left: int, right: int,
                                drop_seed: int = 0, drop_rate: float = 0.0) -> torch.Tensor:
        """Plain limited-context training attention (reference
        attention.py:334-386): queries in chunks of c, each over an unfolded
        window of L + c + R keys. x [B, T, D]; lens [B] valid frames;
        pos_emb [2c - 1 + L + R, D]. The gradient oracle of ``chunked_train``."""
        b, t, d = x.shape
        x = copy_to_tp(x, self.tp)
        c, h = chunk, self.linear_q.weight.shape[0] // self.d_k
        n = -(-t // c)
        w = left + c + right
        pad_t = n * c - t
        q = F.pad(self._heads(self.linear_q, x), (0, 0, 0, 0, 0, pad_t)).view(b * n, c, h, -1)
        kv = torch.cat([self._heads(self.linear_k, x), self._heads(self.linear_v, x)], -1)
        kv = F.pad(kv, (0, 0, 0, 0, left, pad_t + right)).unfold(1, w, c)  # [B, n, H, 2dk, W]
        kv = kv.permute(0, 1, 4, 2, 3).reshape(b * n, w, h, -1)
        k, v = kv.split(self.d_k, dim=-1)
        pad_mask = torch.arange(t, device=x.device)[None] < lens[:, None]
        mask_q = F.pad(pad_mask, (0, pad_t)).view(b * n, c)
        mask_kv = F.pad(pad_mask, (left, pad_t + right)).unfold(1, w, c).reshape(b * n, w)
        mask = mask_q[:, :, None] & mask_kv[:, None, :]
        drop = None
        if drop_rate > 0.0:
            keep = window_keep_mask(drop_seed, lens, n, h, c, w, drop_rate,
                                    *self._head_span(h)).view(b * n, h, c, w)
            drop = lambda a: a * keep / (1.0 - drop_rate)  # noqa: E731
        out = self.rel_attention_core(q, k, v, pos_emb, mask, left, right, drop)
        return out.reshape(b, n * c, d)[:, :t]

    def chunked_train(self, x: torch.Tensor, pos_emb: torch.Tensor, lens: torch.Tensor,
                      chunk: int, left: int, right: int, drop_seed: int = 0,
                      drop_rate: float = 0.0) -> torch.Tensor:
        """Limited-context training attention through the training kernels
        (``attention_chunked_train_pallas``, ``nn/attention.py:142``): the
        padded queries [B, n*c, H, dk], one fused K|V projection into a flat
        stream per utterance behind L zero rows and ahead of R zero rows, the
        per-head positional projection, and ``lens`` in subsampled frames."""
        b, t, d = x.shape
        d_k = self.d_k
        c, h = chunk, self.linear_q.weight.shape[0] // d_k  # this rank's heads
        n = -(-t // c)
        x_pad = F.pad(copy_to_tp(x, self.tp), (0, 0, 0, n * c - t))
        q = self._heads(self.linear_q, x_pad)
        w_kv = torch.stack([self.linear_k.weight.view(h, d_k, d),
                            self.linear_v.weight.view(h, d_k, d)], 1).reshape(2 * h * d_k, d)
        b_kv = torch.stack([self.linear_k.bias.view(h, d_k),
                            self.linear_v.bias.view(h, d_k)], 1).reshape(2 * h * d_k)
        kv = F.linear(x_pad, w_kv, b_kv).view(b, n * c, h, 2 * d_k)
        kv = F.pad(kv, (0, 0, 0, 0, left, right))
        p = self.linear_pos(pos_emb.to(q.dtype)).view(-1, h, d_k)
        offset, total = self._head_span(h)
        ctx = chunk_train_attention(
            q, kv, p, self.pos_bias_u.to(q.dtype), self.pos_bias_v.to(q.dtype),
            lens.to(torch.int32), drop_seed, chunk=c, left=left, right=right,
            drop_rate=drop_rate, head_offset=offset, heads_total=total)
        return row_parallel_linear(self.linear_out, ctx.reshape(b, n * c, h * d_k),
                                   self.tp)[:, :t]
