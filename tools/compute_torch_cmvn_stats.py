#!/usr/bin/env python3
"""Compute global CMVN statistics with ``chunkformer_tpu_torch`` (the twin of
``tools/compute_cmvn_stats.py``; reference: tools/compute_cmvn_stats.py).

Reads a data list (TSV/jsonl), computes each file's Kaldi fbank on the host
(``data/processor.py:compute_fbank_numpy``, no dither) in worker processes,
and writes the reference-compatible JSON:
  {"mean_stat": [...], "var_stat": [...], "frame_num": N}

  python tools/compute_torch_cmvn_stats.py --in_list data/train.list \\
      --out_cmvn data/train/global_cmvn
"""

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stats_for(item):
    path, fbank_conf = item
    from chunkformer_tpu_torch.data.audio import load_audio
    from chunkformer_tpu_torch.data.processor import compute_fbank_numpy

    wav, sr = load_audio(path)
    feat = compute_fbank_numpy(wav, num_mel_bins=fbank_conf.get("num_mel_bins", 80),
                               frame_length=fbank_conf.get("frame_length", 25),
                               frame_shift=fbank_conf.get("frame_shift", 10),
                               dither=0.0, sample_rate=sr)
    return feat.sum(0), (feat ** 2).sum(0), feat.shape[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--in_list", required=True, help="data list (key\\twav\\t...)")
    parser.add_argument("--out_cmvn", required=True)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--num_mel_bins", type=int, default=80)
    args = parser.parse_args(argv)

    from chunkformer_tpu_torch.data.pipeline import text_line_source

    paths = [s["wav"] for s in text_line_source(args.in_list)]
    fbank_conf = {"num_mel_bins": args.num_mel_bins}
    mean = np.zeros(args.num_mel_bins)
    var = np.zeros(args.num_mel_bins)
    frames = 0
    with ProcessPoolExecutor(args.num_workers) as ex:
        for m, v, n in ex.map(_stats_for, [(p, fbank_conf) for p in paths]):
            mean += m
            var += v
            frames += n
    with open(args.out_cmvn, "w") as f:
        json.dump({"mean_stat": mean.tolist(), "var_stat": var.tolist(),
                   "frame_num": frames}, f)
    print(f"wrote {args.out_cmvn}: {frames} frames over {len(paths)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
