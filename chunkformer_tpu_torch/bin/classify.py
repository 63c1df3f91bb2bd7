"""`chunkformer-classify` CLI (counterpart of ``chunkformer_tpu/bin/classify.py``;
reference: chunkformer/bin/classify.py): classify each file of a test list
with a classification export, at full context, into a TSV (a header row of
the tasks, then one label per task a file) or JSONL ({key, task: {label,
label_id, prob}} a line).

    python -m chunkformer_tpu_torch.bin.classify --model_checkpoint <dir> \\
        --test_data test.list --output_file out.tsv [--format jsonl] [--device cpu]

The model runs on ``--device`` (cuda unless named otherwise) in ``--dtype``
(fp32 by default, as the JAX CLI's).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ChunkFormer classification (PyTorch/CUDA)")
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--test_data", required=True)
    p.add_argument("--output_file", required=True)
    p.add_argument("--format", choices=["tsv", "jsonl"], default="tsv")
    p.add_argument("--dtype", choices=["fp32", "bf16", "fp16"], default="fp32",
                   help="Device compute dtype (fp16 maps to bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (cuda unless named otherwise)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from ..api import ChunkFormerModel
    from ..data.pipeline import text_line_source

    dtype = torch.bfloat16 if args.dtype in ("bf16", "fp16") else torch.float32
    model = ChunkFormerModel.from_pretrained(args.model_checkpoint, dtype=dtype,
                                             device=args.device)
    samples = list(text_line_source(args.test_data))
    with open(args.output_file, "w") as out:
        header_written = False
        for s in samples:
            preds = model.classify_audio(s["wav"])   # full context
            if args.format == "jsonl":
                out.write(json.dumps({"key": s.get("key", s["wav"]), **preds}) + "\n")
            else:
                tasks = sorted(preds.keys())
                if not header_written:
                    out.write("key\t" + "\t".join(tasks) + "\n")
                    header_written = True
                out.write(s.get("key", s["wav"]) + "\t"
                          + "\t".join(preds[t]["label"] for t in tasks) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
