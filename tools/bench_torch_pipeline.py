#!/usr/bin/env python3
"""Input-pipeline throughput of the port: utterances/s of ``data/pipeline.py``
``Dataset`` into a consumer that copies each batch's features to the device
(counterpart of ``tools/bench_pipeline.py``).

    python3 tools/bench_torch_pipeline.py [--n 256] [--seconds 8] [--json out.json]

Writes ``--n`` synthetic WAVs (16 kHz noise of 0.5-1.5 x ``--seconds``,
seeded as the JAX tool's) and a char vocabulary once, then drives the whole
chain (WAV read -> the native host library's fbank -> tokenize -> filter ->
sort -> batch -> collate) four ways: static batches of 16 without and with
``prefetch_buffer`` 8 (the pipeline in a background thread), bucket batches
and dynamic batches of 16,000 frames, both with prefetch. Each batch's
features go to ``--device`` (``cuda`` by default; the Executor's copy) and
the device is synchronised before the clock stops. Prints a line per
variant and one JSON object ``{"device", "variants": [{"name",
"utts_per_s", "utts", "batches", "seconds"}]}``; ``--json PATH`` writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE = {"fbank_conf": {"num_mel_bins": 80, "dither": 0.0},
        "filter_conf": {"max_length": 102400}, "shuffle": False, "sort": True}
VARIANTS = [
    ("static, no prefetch", {**BASE, "batch_conf": {"batch_size": 16}}),
    ("static, prefetch=8", {**BASE, "batch_conf": {"batch_size": 16}, "prefetch_buffer": 8}),
    ("bucket, prefetch=8", {**BASE, "prefetch_buffer": 8,
                            "batch_conf": {"batch_type": "bucket",
                                           "bucket_boundaries": [800, 1200],
                                           "bucket_batch_sizes": [24, 16, 8]}}),
    ("dynamic, prefetch=8", {**BASE, "prefetch_buffer": 8,
                             "batch_conf": {"batch_type": "dynamic",
                                            "max_frames_in_batch": 16000}}),
]


def make_data(root: str, n: int, seconds: float):
    """The JAX tool's WAVs, data list and units.txt (the same seed and draws)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        path = os.path.join(root, f"w{i}.wav")
        t = int(16000 * seconds * rng.uniform(0.5, 1.5))
        wavfile.write(path, 16000, (rng.normal(size=t) * 3000).astype(np.int16))
        lines.append(f"u{i}\t{path}\txin chao the gioi\n")
    lst = os.path.join(root, "data.list")
    with open(lst, "w") as f:
        f.writelines(lines)
    units = os.path.join(root, "units.txt")
    with open(units, "w", encoding="utf-8") as f:
        f.write("<blank> 0\n<unk> 1\n")
        for i, ch in enumerate(sorted(set("xinchaothegioi ")), start=2):
            f.write(f"{'▁' if ch == ' ' else ch} {i}\n")
    return lst, units


def run_once(lst: str, units: str, conf: dict, device: torch.device):
    """(utterances, batches, seconds) of one pass over the list."""
    from chunkformer_tpu_torch.data.pipeline import Dataset
    from chunkformer_tpu_torch.data.tokenizer import build_tokenizer

    ds = Dataset("raw", lst, build_tokenizer("char", {"symbol_table_path": units}), conf)
    pin = device.type == "cuda"
    t0 = time.perf_counter()
    utts = batches = 0
    for batch in ds:
        feats = torch.from_numpy(batch["feats"])
        if pin:
            feats = feats.pin_memory()
        feats.to(device, non_blocking=pin)
        utts += batch["feats"].shape[0]
        batches += 1
    if pin:
        torch.cuda.synchronize(device)
    return utts, batches, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    from chip_smoke import card_name

    results = []
    with tempfile.TemporaryDirectory() as root:
        lst, units = make_data(root, args.n, args.seconds)
        for name, conf in VARIANTS:
            utts, batches, seconds = run_once(lst, units, conf, device)
            results.append({"name": name, "utts_per_s": utts / seconds, "utts": utts,
                            "batches": batches, "seconds": seconds})
            print(f"{name:22s}: {utts / seconds:8.1f} utts/s  ({batches} batches)", flush=True)
    out = {"device": card_name(device), "n": args.n, "seconds": args.seconds,
           "variants": results}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
