#!/usr/bin/env python3
"""Knock-out timing of the port's flagship train step (counterpart of
``tools/ablate_train_step.py``).

    python3 tools/ablate_torch_train_step.py [variant ...] [--steps 5] [--json out.json]

The hybrid CTC/AED step of bench.py:149-177 (ChunkFormer-large encoder with
"dots" gradient checkpointing, bitransformer decoder 3 + 3, vocabulary
6992, adamw at lr 1e-3 with warmuplr, clip 5; 32 utterances of 1600 frames,
48 labels, chunks (64, 128, 128), bf16 autocast, dropout on), built with
the port's ``make_train_step`` on weights from
``utils/params.py:random_params_like`` (seed 1), with parts knocked out:

  full          the step as it is (the training attention kernels B4/B5)
  attn-plain    the training attention through its plain version
                (``attention_chunked_train``: unfold, rel-shift, softmax)
  attn-skip     the attention replaced by the identity
  no-decoder    ctc_weight 1.0: no attention-decoder loss
  no-remat      gradient_checkpointing off (activations kept)
  no-dropout    every dropout rate 0

Each variant builds its model and step anew, runs one step (printed with
its loss), then ``--steps`` steps timed by the host clock after a device
synchronise. A knock-out patches a method of the attention class inside
this tool and restores it after the variant. Prints a line per variant and
the marginal cost of each against "full", then one JSON object
``{"device", "batch", "ms": {variant: ms a step}, "loss": {variant: the
first step's loss}}``; ``--json PATH`` writes it.
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

VARIANTS = ("full", "attn-plain", "attn-skip", "no-decoder", "no-remat", "no-dropout")
CHUNK = (64, 128, 128)


def build_cfg(variant: str, d_model: int = 512, num_blocks: int = 17):
    """The bench.py:149-177 configuration (at ``d_model`` and ``num_blocks``)
    with ``variant``'s changes (ablate_train_step.py:29-63)."""
    from chip_smoke import scaled_large
    from chunkformer_tpu_torch.config import ChunkFormerConfig

    d = scaled_large(d_model, num_blocks)
    enc = {**d["encoder_conf"], "gradient_checkpointing": variant != "no-remat",
           "remat_policy": "dots"}
    dec = {"attention_heads": enc["attention_heads"], "linear_units": enc["linear_units"],
           "num_blocks": 3, "r_num_blocks": 3}
    model_conf = {"ctc_weight": 1.0 if variant == "no-decoder" else 0.3,
                  "reverse_weight": 0.3, "lsm_weight": 0.1}
    if variant == "no-dropout":
        enc.update(dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
        dec.update(dropout_rate=0.0, positional_dropout_rate=0.0)
    return ChunkFormerConfig.from_dict({"model": "asr_model", "encoder_conf": enc,
                                        "decoder": "bitransformer", "decoder_conf": dec,
                                        "model_conf": model_conf,
                                        "output_dim": d["output_dim"]})


def make_batch(vocab: int, batch: int, frames: int, labels: int, device: torch.device):
    """Seeded features [B, T, 80], lengths, targets [B, U] and their lengths
    (the JAX tool's draws: ``np.random.default_rng(2)``)."""
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(batch, frames, 80)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(1, vocab - 2, size=(batch, labels)))
    return (feats.to(device), torch.full((batch,), frames, dtype=torch.int32, device=device),
            targets.to(device), torch.full((batch,), labels, dtype=torch.int32, device=device))


def build_step(cfg, device: torch.device):
    """(model, step) as the bench's train step: weights from
    ``random_params_like`` (seed 1), adamw, warmuplr, bf16 autocast, clip 5."""
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step
    from chunkformer_tpu_torch.utils.params import random_params_like

    model = random_params_like(ASRModel(cfg), seed=1).to(device)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                 {"warmup_steps": 25000})
    return model, make_train_step(model, cfg, opt, sched, CHUNK, autocast=torch.bfloat16,
                                  grad_clip=5.0)


def patch_targets():
    """(owner, attribute) of everything a knock-out can replace."""
    from chunkformer_tpu_torch.nn.attention import RelPositionMultiHeadedAttention as Attn

    return [(Attn, "chunked_train"), (Attn, "full")]


@contextlib.contextmanager
def knocked_out(variant: str):
    from chunkformer_tpu_torch.nn.attention import RelPositionMultiHeadedAttention as Attn

    saved = [(owner, name, getattr(owner, name)) for owner, name in patch_targets()]
    try:
        if variant == "attn-plain":
            Attn.chunked_train = Attn.attention_chunked_train
        elif variant == "attn-skip":
            Attn.chunked_train = lambda self, x, *a, **k: x
            Attn.full = lambda self, x, *a, **k: x
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def run_variant(variant: str, args, batch, device: torch.device):
    """(ms a step, the first step's loss) of ``variant``."""
    cfg = build_cfg(variant, args.d_model, args.num_blocks)
    with knocked_out(variant):
        model, step = build_step(cfg, device)
        gen = torch.Generator().manual_seed(0)
        loss = float(step(*batch, gen)["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            metrics = step(*batch, gen)
        float(metrics["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
    del model, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ms, loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)} (all)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1600)
    ap.add_argument("--labels", type=int, default=48)
    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--num_blocks", type=int, default=17)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; choose from {', '.join(VARIANTS)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    from chip_smoke import card_name

    batch = make_batch(build_cfg("full").vocab_size, args.batch, args.frames, args.labels,
                       device)
    audio_s = args.batch * args.frames * 0.01
    ms, loss = {}, {}
    for variant in args.variants or VARIANTS:
        ms[variant], loss[variant] = run_variant(variant, args, batch, device)
        print(f"{variant:12s} {ms[variant]:8.1f} ms/step {audio_s / ms[variant] * 1e3:8.1f} "
              f"audio-s/s (first step's loss {loss[variant]:.4f})", flush=True)
    if "full" in ms:
        for v in ms:
            if v != "full":
                print(f"marginal {v:12s}: {ms['full'] - ms[v]:+8.1f} ms", flush=True)
    out = {"device": card_name(device), "batch": [args.batch, args.frames, args.labels],
           "chunk": list(CHUNK), "ms": ms, "loss": loss}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
