#!/usr/bin/env python3
"""Knock-out timing of the port's decode segment: which part dominates?
(counterpart of ``tools/ablate_step.py``)

    python3 tools/ablate_torch_step.py [--iters 8] [--json out.json]

Times one macro-segment of ``endless_decode`` (the encoder's
``parallel_chunk`` on ChunkFormer-large's packed rows at (64, 128, 128) and
the CTC argmax, in bf16, random weights from
``utils/params.py:random_params_like``) with parts knocked out, to attribute
the segment's time: the attention through B1's plain version instead of
its kernel, no CTC head, attention, conv module, FFNs, the layers' norms
or the subsampling replaced by the identity (or a cheap stand-in that
keeps the data dependency), attention and conv together, and all of them
("overhead floor"). The segment is the JAX tool's: 600 s of budget,
``trunc`` = 3712 frames, the capacity rounded up to a multiple of 16
(96 rows). Each knock-out patches a method or a module attribute inside
this tool and restores it on exit; nothing switches in the package.

Each variant runs once, then ``--iters`` times with the caches carried from
call to call, the host clock stopped after a device synchronise. Prints a
line per variant (ms, audio-s/s) and one JSON object ``{"device",
"segment_audio_s", "chunk", "capacity", "ms": {variant: ms}}``; ``--json
PATH`` writes it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C, LEFT, RIGHT = 64, 128, 128
VARIANTS = [
    ("full", {}),
    ("full (plain attention)", {"plain_attention": True}),
    ("no ctc head", {"ctc": False}),
    ("no attention", {"attn": True}),
    ("no conv", {"conv": True}),
    ("no ffn", {"ffn": True}),
    ("no norms", {"norms": True}),
    ("no subsampling", {"embed": True}),
    ("no attn+conv", {"attn": True, "conv": True}),
    ("overhead floor", {"ctc": False, "attn": True, "conv": True, "ffn": True, "norms": True,
                        "embed": True}),
]


def patch_targets():
    """(owner, attribute) of everything a knock-out can replace."""
    from torch import nn

    from chunkformer_tpu_torch.nn import attention, convolution, encoder, layers

    return [(attention, "chunk_attention"),
            (attention.RelPositionMultiHeadedAttention, "parallel_chunk"),
            (convolution.ConvolutionModule, "parallel_chunk"),
            (layers.PositionwiseFeedForward, "forward"),
            (nn.LayerNorm, "forward"),
            (encoder.ChunkFormerEncoder, "embed_features")]


@contextlib.contextmanager
def knocked_out(model, plain_attention=False, attn=False, conv=False, ffn=False, norms=False,
                embed=False):
    """``model`` with the named parts replaced; every replaced attribute is
    the original object again on exit."""
    from torch import nn

    from chunkformer_tpu_torch.nn import attention, convolution, encoder, layers
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain

    saved = [(owner, name, getattr(owner, name)) for owner, name in patch_targets()]
    layer_norms = {id(m) for layer in model.encoder.encoders for name, m in
                   layer.named_children() if name.startswith("norm_")}
    layer_norm_forward = nn.LayerNorm.forward
    sub = model.encoder.cfg.subsampling_rate
    d = model.encoder.cfg.output_size
    try:
        if plain_attention:
            attention.chunk_attention = chunk_attention_plain
        if attn:
            attention.RelPositionMultiHeadedAttention.parallel_chunk = (
                lambda self, x, pos_emb, ci, off, ml, cache, *a, **k: (x, cache))
        if conv:
            convolution.ConvolutionModule.parallel_chunk = (
                lambda self, x, mask, cache, *a, **k: (x, cache))
        if ffn:
            layers.PositionwiseFeedForward.forward = lambda self, x, *a, **k: x
        if norms:
            nn.LayerNorm.forward = lambda self, x: (
                x if id(self) in layer_norms else layer_norm_forward(self, x))
        if embed:
            # a cheap stand-in with the data dependency on xs (ablate_step.py:78-82)
            encoder.ChunkFormerEncoder.embed_features = lambda self, xs: (
                xs[:, :((xs.shape[1] - 15) // sub + 1) * sub:sub, :1].expand(-1, -1, d)
                .contiguous())
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def build_model(d_model: int, num_blocks: int, dtype: torch.dtype, device: torch.device):
    """ChunkFormer-large (or the given widths) with random weights, in eval."""
    from chip_smoke import scaled_large
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.utils.params import random_params_like

    cfg = ChunkFormerConfig.from_dict(scaled_large(d_model, num_blocks))
    return random_params_like(ASRModel(cfg)).to(device=device, dtype=dtype).eval()


def segment_inputs(model, seconds: float, device: torch.device):
    """The packed rows of one macro-segment at a ``seconds`` budget, sized as
    ``tools/ablate_step.py:121-140``: (xs, chunk_idx, offsets, max_lens),
    trunc, capacity."""
    from chunkformer_tpu_torch.ops import chunk as chunk_ops

    cfg = model.encoder.cfg
    sub = cfg.subsampling_rate
    max_frames = int(seconds // 0.01) // 2
    trunc = C * max(max_frames // C // sub, 1)
    r_prime = max(RIGHT, cfg.conv_lorder)
    rel_right = (r_prime + max(C, r_prime) * (cfg.num_blocks - 1)) * sub
    seg_raw = trunc * sub + 7 + rel_right
    size = (C - 1) * sub + chunk_ops.SUBSAMPLING_CONTEXT
    # rounded up to 16 rows as the JAX tool, so both time the same segment
    capacity = -(-((seg_raw - size) // (sub * C) + 1) // 16) * 16
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(seg_raw, 80)).astype(np.float32))
    packed = chunk_ops.pack_chunks([x], [seg_raw], C, sub, offsets=[0], capacity=capacity)
    dtype = next(model.parameters()).dtype

    def meta(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    rows = (packed.xs.to(device=device, dtype=dtype), meta(packed.chunk_idx),
            meta(packed.offsets), meta(packed.max_lens))
    return rows, trunc, capacity


@torch.inference_mode()
def run_variant(model, rows, trunc: int, iters: int, ctc: bool = True, **knock):
    """(ms a segment, the first call's tokens) with ``knock`` knocked out."""
    device = rows[0].device
    dtype = next(model.parameters()).dtype

    def step(att, cnn):
        out, att, cnn = model.encoder.parallel_chunk(*rows, C, LEFT, RIGHT, att, cnn, trunc)
        return (model.ctc.argmax(out) if ctc else out[..., 0]), att, cnn

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with knocked_out(model, **knock):
        att, cnn = model.encoder.init_caches(LEFT, dtype, device)
        first, att, cnn = step(att, cnn)
        first = first.cpu()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            tokens, att, cnn = step(att, cnn)
        tokens.cpu()
        sync()
        return (time.perf_counter() - t0) / iters * 1e3, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=600.0, help="segment budget")
    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--num_blocks", type=int, default=17)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    from chip_smoke import card_name

    model = build_model(args.d_model, args.num_blocks, torch.bfloat16, device)
    rows, trunc, capacity = segment_inputs(model, args.seconds, device)
    audio_s = trunc * model.encoder.cfg.subsampling_rate / 100.0
    ms = {}
    for name, kw in VARIANTS:
        ms[name], _ = run_variant(model, rows, trunc, args.iters, **kw)
        print(f"{name:22s}: {ms[name]:8.2f} ms   ({audio_s / ms[name] * 1e3:9.1f} audio-s/s)",
              flush=True)
    out = {"device": card_name(device), "segment_audio_s": audio_s, "chunk": [C, LEFT, RIGHT],
           "capacity": capacity, "ms": ms}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
