"""ChunkFormer encoder (counterpart of ``chunkformer_tpu/nn/encoder.py``):
``_embed`` :85-107, ``init_caches`` :218, ``encoder_parallel_chunk`` :234
(masked-batch inference, reference encoder.py:503-681),
``encoder_streaming_step`` :301 (one incremental step, reference
encoder.py:310-385) and ``encoder_forward`` :114 (full and limited-context
batch forward for training and evaluation, reference
encoder.py:220-308,461-501).

A Python loop over the layers takes the place of ``lax.scan``; the per-layer
KV and conv caches are stacked as [n_layers, L, H, 2dk] and
[n_layers, D, lorder]. Under ``gradient_checkpointing`` each layer is wrapped
in ``torch.utils.checkpoint`` (non-reentrant); its dropout masks come from
seeds drawn before the layer loop, so a recompute draws the same masks. In
train mode a batch-norm conv module's running statistics are updated by
momentum once per forward, after the layer's (checkpointed) function returns
them (torch ``BatchNorm1d`` semantics; the buffers stay out of the optimizer).
"""

from __future__ import annotations

import functools
import math
import random
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import EncoderConfig
from ..ops.chunk import parallel_chunk_conv_mask
from ..ops.chunk_attention_train import FORWARD_OP
from ..ops.masks import make_non_pad_mask
from .embedding import rel_pos_slice
from .encoder_layer import ChunkFormerEncoderLayer
from .layers import dropout, make_norm
from .subsampling import DepthwiseConvSubsampling

# "dots": keep the outputs of matrix products without batch dimensions (the
# linear layers; JAX's dots_with_no_batch_dims_saveable) and of the training
# attention kernel (ctx, m, den); recompute everything else
_DOTS_SAVED = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, FORWARD_OP}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def subsampled_lengths(lengths: torch.Tensor, sampling_num: int = 3) -> torch.Tensor:
    """Frames after the stride-2 conv stack, in f32 as ``calc_length_jax``."""
    x = lengths.float()
    for _ in range(sampling_num):
        x = torch.floor((x - 3) / 2 + 1.0)
    return x.to(torch.int32)


def limited_context_selection(cfg: EncoderConfig, rng: random.Random = random
                              ) -> Tuple[int, int, int]:
    """Sample (chunk, L, R) for dynamic-chunk training (encoder.py:198-218)."""
    if not (cfg.dynamic_chunk_sizes and cfg.dynamic_left_context_sizes
            and cfg.dynamic_right_context_sizes):
        return 0, 0, 0
    c = rng.choice(cfg.dynamic_chunk_sizes)
    left = rng.choice(cfg.dynamic_left_context_sizes)
    if cfg.streaming:
        right = rng.choice([r for r in cfg.dynamic_right_context_sizes if r < c])
    else:
        right = rng.choice(cfg.dynamic_right_context_sizes)
    if c <= 0:
        return 0, 0, 0
    return c, left, right


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

    def init_caches(self, left_context_size: int, dtype: torch.dtype, device: torch.device,
                    batch: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero caches. Parallel-chunk layout: att [n_layers, L, H, 2dk], cnn
        [n_layers, D, lorder]; with ``batch`` (streaming): att
        [n_layers, B, L, H, 2dk], cnn [n_layers, B, D, lorder]."""
        cfg = self.cfg
        b = () if batch is None else (batch,)
        att = torch.zeros((cfg.num_blocks, *b, left_context_size, cfg.attention_heads,
                           2 * cfg.head_dim), dtype=dtype, device=device)
        cnn = torch.zeros((cfg.num_blocks, *b, cfg.output_size, cfg.conv_lorder),
                          dtype=dtype, device=device)
        return att, cnn

    def parallel_chunk(
        self, xs: torch.Tensor, chunk_idx: torch.Tensor, offsets: torch.Tensor,
        max_lens: torch.Tensor, chunk_size: int, left_context_size: int,
        right_context_size: int, att_cache: torch.Tensor, cnn_cache: torch.Tensor,
        truncated_context_size: int = 0, group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked-batch inference over packed chunk rows xs [N, size, feat].

        chunk_idx / offsets / max_lens are int32 [N] on the device of xs.
        Returns (out [N, c, D], new_att_cache, new_cnn_cache).

        With ``group`` (a process group), each rank passes its block of the
        batch's rows and their metadata (``parallel/row_shard.py``
        ``split_rows``) and the same caches and ``truncated_context_size``;
        every layer's attention and conv module exchange halo rows with the
        neighbouring ranks. Each rank gets the outputs of its rows and the
        new caches of the whole batch, the same on every rank.
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
                                           truncated_context_size, group)
            new_att.append(a)
            new_cnn.append(k)
        if cfg.normalize_before and cfg.final_norm:
            x = self.after_norm(x)
        return x, torch.stack(new_att), torch.stack(new_cnn)

    def streaming_step(
        self, xs: torch.Tensor, att_cache: torch.Tensor, cnn_cache: torch.Tensor,
        chunk_size: int, left_context_size: int, right_context_size: int, offset: int,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One incremental streaming step (``encoder_streaming_step``).

        xs [B, T_in, feat] are the raw frames of c + R subsampled frames;
        att_cache [n_layers, B, L, H, 2dk] and cnn_cache [n_layers, B, D,
        lorder] as ``init_caches(..., batch=B)`` makes them; ``offset`` is
        the subsampled frames decoded so far. Returns (out [B, c + R, D],
        new_att_cache, new_cnn_cache): the first c output frames are final,
        the trailing R are lookahead, recomputed by the next step and never
        cached.
        """
        cfg = self.cfg
        c, L, R = chunk_size, left_context_size, right_context_size
        x = self.embed_features(xs)                                # [B, c + R, D]
        b, t1 = x.shape[:2]
        pos_emb = torch.from_numpy(rel_pos_slice(cfg.output_size, c + R, L, 0, cfg.max_pos_len))
        pos_emb = pos_emb.to(device=x.device, dtype=x.dtype)
        # position p of the L cache rows and t1 new frames is valid iff
        # p >= L - offset: cache rows beyond the decoded history are empty
        mask = torch.arange(L + t1, device=x.device) >= L - offset
        mask = mask.expand(b, 1, L + t1)
        lorder = cfg.conv_lorder
        new_att, new_cnn = [], []
        for i, layer in enumerate(self.encoders):
            x, kv_full, stream = layer.streaming(x, pos_emb, mask, att_cache[i], cnn_cache[i], c)
            # keep the L rows (lorder columns) that end R before the end
            kv_len = kv_full.shape[1]
            new_att.append(kv_full[:, kv_len - L - R:kv_len - R])
            if stream is None:
                new_cnn.append(cnn_cache[i])
            else:
                cs_len = stream.shape[2]
                new_cnn.append(stream[:, :, cs_len - lorder - R:cs_len - R])
        if cfg.normalize_before and cfg.final_norm:
            x = self.after_norm(x)
        return x, torch.stack(new_att), torch.stack(new_cnn)

    def _layer_train(self, layer: ChunkFormerEncoderLayer, pos_emb: torch.Tensor,
                     lens: torch.Tensor, pad_mask: torch.Tensor, chunk_size: int, left: int,
                     right: int, train: bool, seeds: Optional[Tuple[int, int]],
                     x: torch.Tensor) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """One block of ``forward_train``; returns (x, the conv module's new
        batch-norm running statistics, or None). The statistics leave the
        (possibly checkpointed) function rather than being written inside
        it, because a recompute reruns its body."""
        cfg = self.cfg
        c = chunk_size
        gen = None
        if seeds is not None:
            gen = torch.Generator(device=x.device).manual_seed(seeds[0])
        att_rate = cfg.attention_dropout_rate if gen is not None else 0.0
        att_seed = seeds[1] if seeds is not None else 0

        def attn_fn(h):
            if c > 0:
                return layer.self_attn.chunked_train(h, pos_emb, lens, c, left, right,
                                                     att_seed, att_rate)
            return layer.self_attn.full(h, pos_emb, pad_mask[:, None, :], att_rate, gen)

        stats = []

        def conv_fn(h):
            y, new_stats = layer.conv_module.full(
                h, pad_mask, c if cfg.dynamic_conv and c > 0 else 0, cfg.causal, train)
            stats.append(new_stats)
            return y, new_stats

        x = layer.forward_train(x, attn_fn, conv_fn if layer.conv_module is not None
                                else None, cfg.dropout_rate if gen is not None else 0.0, gen)
        return x, (stats[0] if stats else None)

    def forward_train(
        self, xs: torch.Tensor, xs_lens: torch.Tensor, chunk_size: int = 0,
        left_context_size: int = 0, right_context_size: int = 0, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch forward (``encoder_forward``): xs [B, T, feat], xs_lens [B].

        chunk_size > 0 runs limited-context attention over (c, L, R) through
        the training kernels; 0 runs full context. Dropout is on when
        ``train`` and a (CPU) ``generator`` are given; the batch norm uses
        batch statistics when ``train``. Returns (out [B, T', D], pad_mask
        [B, T'] True = valid).
        """
        cfg = self.cfg
        c, L, R = chunk_size, left_context_size, right_context_size
        x = self.embed_features(xs)
        t2 = x.shape[1]
        out_lens = subsampled_lengths(xs_lens)
        pad_mask = make_non_pad_mask(out_lens, t2)
        pos_emb = torch.from_numpy(rel_pos_slice(cfg.output_size, c if c > 0 else t2, L, R,
                                                 cfg.max_pos_len))
        pos_emb = pos_emb.to(device=x.device, dtype=x.dtype)
        seeds = [None] * cfg.num_blocks
        if train and generator is not None:
            draws = torch.randint(0, 2 ** 62, (1 + 2 * cfg.num_blocks,), generator=generator)
            draws = draws.tolist()
            gen = torch.Generator(device=x.device).manual_seed(draws[0])
            x = dropout(x, cfg.positional_dropout_rate, gen)
            pos_emb = dropout(pos_emb, cfg.positional_dropout_rate, gen)
            seeds = [(draws[1 + 2 * i], draws[2 + 2 * i] & 0xFFFFFFFF)
                     for i in range(cfg.num_blocks)]

        remat = train and cfg.gradient_checkpointing and torch.is_grad_enabled()
        context_fn = None
        if remat and cfg.remat_policy == "dots":
            context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        elif remat and cfg.remat_policy != "nothing":
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        for layer, sd in zip(self.encoders, seeds):
            fn = functools.partial(self._layer_train, layer, pos_emb, out_lens, pad_mask,
                                   c, L, R, train, sd)
            if remat:
                kw = {"context_fn": context_fn} if context_fn is not None else {}
                x, stats = checkpoint(fn, x, use_reentrant=False, **kw)
            else:
                x, stats = fn(x)
            if stats is not None:  # once per forward, never from a recompute
                with torch.no_grad():
                    norm = layer.conv_module.norm
                    norm.running_mean.copy_(stats["mean"])
                    norm.running_var.copy_(stats["var"])
                    norm.num_batches_tracked += 1
        if cfg.normalize_before and cfg.final_norm:
            x = self.after_norm(x)
        return x, pad_mask
