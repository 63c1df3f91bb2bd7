#!/usr/bin/env python3
"""Training-descent evidence for chunkformer_tpu_torch on the card (the twin
of tools/train_descent_run.py).

Runs 120+ optimizer steps of the flagship hybrid CTC/AED model (512 d, 8
heads, 17 blocks, the 3 + 3-block decoder, vocab 6992, remat "dots") through
the port's Executor (``train/executor.py``: one cached ``make_train_step`` a
(c, L, R), the triple drawn again each step from the config lists with
``random.Random(7)``, dropout on) over the JAX tool's small learnable dataset:
4 fixed batches of 8 utterances x 12 s of seeded random features (rounded to
bf16, as the JAX tool feeds them) with 24 fixed target tokens each. The
parameters are ``utils/params.py:random_params_like(seed=1)``, the optimizer
adamw at lr 5e-4 with 60 warmup steps and a 5.0 clip, all in float32.

Writes artifacts/train_descent_torch.jsonl, one line a step in the JAX
artifact's format: step, chunk_cfg (the triple the Executor drew), loss, loss_ctc, loss_att, grad_norm,
step_s (the Executor's step seconds, card wait included) and audio_s_per_s;
then prints the mean loss of the first and the last ten steps and fails
unless it fell.

  python tools/train_torch_descent_run.py [steps] [--device cuda|cpu] [--out PATH]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLAGSHIP = {
    "model": "asr_model",
    "encoder_conf": {
        "output_size": 512, "attention_heads": 8, "linear_units": 2048,
        "num_blocks": 17, "cnn_module_kernel": 15,
        "cnn_module_norm": "layer_norm", "dynamic_conv": True,
        "gradient_checkpointing": True, "remat_policy": "dots",
        # flagship dynamic-chunk lists (reference conf/*.yaml:22-24)
        "dynamic_chunk_sizes": [64, 128],
        "dynamic_left_context_sizes": [64, 128],
        "dynamic_right_context_sizes": [64, 128],
    },
    "decoder": "bitransformer",
    "decoder_conf": {"attention_heads": 8, "linear_units": 2048,
                     "num_blocks": 3, "r_num_blocks": 3},
    "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
    "output_dim": 6992,
}
# the JAX tool's data: batches x (utterances, frames, target tokens)
DATA = (4, 8, 1200, 24)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                  "train_descent_torch.jsonl"))
    return ap.parse_args(argv)


def make_batches(vocab_size, n_batches, b, t_frames, u, seed=0):
    """The fixed learnable dataset, as collated batches of host arrays."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        feats = torch.from_numpy(rng.normal(size=(b, t_frames, 80)).astype(np.float32))
        out.append({"feats": feats.bfloat16().float().numpy(),
                    "feats_lengths": np.full((b,), t_frames, np.int32),
                    "target": rng.integers(1, vocab_size - 2, size=(b, u)).astype(np.int64),
                    "target_lengths": np.full((b,), u, np.int32)})
    return out


def run(cfg_dict, data, n_steps, device, out_path):
    """``n_steps`` Executor steps over ``data`` = (batches, utterances,
    frames, tokens); writes one JSON line a step to ``out_path`` and returns
    the records."""
    import torch

    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.train.executor import Executor
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.utils.params import random_params_like

    cfg = ChunkFormerConfig.from_dict(cfg_dict)
    model = random_params_like(ASRModel(cfg, cmvn=False), seed=1).to(device)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 5e-4},
                                 "warmuplr", {"warmup_steps": 60})
    n_batches, b, t_frames, u = data
    batches = make_batches(cfg.vocab_size, n_batches, b, t_frames, u)
    audio_s = b * t_frames * 0.01
    records = []
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with tempfile.TemporaryDirectory() as model_dir, open(out_path, "w") as f:
        ex = Executor(cfg, model, opt, sched, model_dir, log_interval=1, seed=7,
                      grad_clip=5.0)
        drawn = []  # the (c, L, R) the Executor trained each step at
        sample = ex._sample_chunk_cfg

        def record_draw():
            drawn.append(sample())
            return drawn[-1]

        ex._sample_chunk_cfg = record_draw
        for i in range(n_steps):
            ex.train_epoch([batches[i % n_batches]], epoch=0)
            chunk_cfg = list(drawn[-1])
            with open(os.path.join(model_dir, "metrics.jsonl")) as m:
                metrics = json.loads(m.readlines()[-1])
            dt = ex.timings[-1][1]
            rec = {"step": i + 1, "chunk_cfg": chunk_cfg,
                   "loss": round(metrics["loss"], 4),
                   "loss_ctc": round(metrics.get("loss_ctc", 0.0), 4),
                   "loss_att": round(metrics.get("loss_att", 0.0), 4),
                   "grad_norm": round(metrics["grad_norm"], 3),
                   "step_s": round(dt, 3),
                   "audio_s_per_s": round(audio_s / dt, 1)}
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if (i + 1) % 10 == 0 or dt > 5:
                print(f"step {i + 1}: loss {rec['loss']:.3f} cfg={tuple(chunk_cfg)} "
                      f"{dt * 1000:.0f} ms", file=sys.stderr, flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return records


def main(argv=None):
    import torch

    args = parse_args(argv)
    records = run(FLAGSHIP, DATA, args.steps, torch.device(args.device), args.out)
    first = np.mean([r["loss"] for r in records[:10]])
    last = np.mean([r["loss"] for r in records[-10:]])
    print(f"mean loss first10 {first:.2f} -> last10 {last:.2f}")
    if not last < first:
        print("loss did not descend", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
