"""`chunkformer-decode` CLI (counterpart of ``chunkformer_tpu/bin/decode.py``;
reference: chunkformer/chunkformer_model.py:648-816).

Long-form decoding of a single audio file or masked-batch decoding of a TSV
list, with optional WER scoring when the list carries a `txt` column:

    python -m chunkformer_tpu_torch.bin.decode --model_checkpoint <dir> --audio_file <wav>

The model runs on ``--device`` (cuda unless named otherwise).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ChunkFormer inference CLI (PyTorch/CUDA)")
    parser.add_argument("--model_checkpoint", type=str, required=True,
                        help="Path to an exported model directory")
    parser.add_argument("--total_batch_duration", type=int, default=1800,
                        help="Total audio seconds processed per device pass")
    parser.add_argument("--chunk_size", type=int, default=64)
    parser.add_argument("--left_context_size", type=int, default=128)
    parser.add_argument("--right_context_size", type=int, default=128)
    parser.add_argument("--audio_file", type=str, default=None,
                        help="Single audio file (long-form decode)")
    parser.add_argument("--audio_list", type=str, default=None,
                        help="TSV with a 'wav' column; optional 'txt' column for WER")
    parser.add_argument("--full_attn", action="store_true",
                        help="Full attention with caching instead of "
                             "limited-chunk attention (reference "
                             "chunkformer_model.py:696-701)")
    parser.add_argument("--dtype", "--autocast_dtype", dest="dtype",
                        choices=["fp32", "bf16", "fp16"], default="bf16",
                        help="Device compute dtype (fp16 maps to bf16, as in chunkformer_tpu)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on (cuda unless named otherwise)")
    # NOTE: the reference parses --full_attn but never consumes it
    # (chunkformer_model.py:696-701 vs main body); accepted for CLI parity.
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.audio_file and not args.audio_list:
        print("error: --audio_file or --audio_list required", file=sys.stderr)
        return 2

    import torch

    from ..api import ChunkFormerModel
    from ..config import ChunkFormerConfig

    dtype = torch.bfloat16 if args.dtype in ("bf16", "fp16") else torch.float32
    cfg_path = os.path.join(args.model_checkpoint, "config.yaml")
    if os.path.exists(cfg_path) and ChunkFormerConfig.from_yaml(cfg_path).model \
            == "classification":
        raise SystemExit("classification checkpoints are not ported yet (ROADMAP A19)")
    print(f"Loading model from {args.model_checkpoint} (dtype={args.dtype})")
    model = ChunkFormerModel.from_pretrained(args.model_checkpoint, dtype=dtype,
                                             device=args.device)

    t0 = time.perf_counter()
    if args.audio_file:
        result = model.endless_decode(
            args.audio_file,
            chunk_size=args.chunk_size,
            left_context_size=args.left_context_size,
            right_context_size=args.right_context_size,
            total_batch_duration=args.total_batch_duration,
            return_timestamps=True,
        )
        for item in result:
            print(f"{item['start']} - {item['end']}: {item['decode']}")
    else:
        with open(args.audio_list, newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        paths = [r["wav"] for r in rows]
        hyps = model.batch_decode(
            paths,
            chunk_size=args.chunk_size,
            left_context_size=args.left_context_size,
            right_context_size=args.right_context_size,
            total_batch_duration=args.total_batch_duration,
        )
        for row, hyp in zip(rows, hyps):
            print(f"{row.get('key', row['wav'])}\t{hyp}")
        if rows and "txt" in rows[0] and rows[0]["txt"]:
            from ..decode.outputs import word_error_rate

            wer = word_error_rate(hyps, [r["txt"] for r in rows])
            print(f"WER: {wer:.4f}")
    print(f"elapsed: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
