"""Checkpoint averaging CLI (counterpart of ``chunkformer_tpu/bin/average_model.py``;
reference chunkformer/bin/average_model.py:55-116): the best N (by CV loss)
or the last N checkpoints of a model_dir into one.

    python -m chunkformer_tpu_torch.bin.average_model --src_path exp --num 5
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Average checkpoints")
    p.add_argument("--src_path", required=True, help="model_dir with checkpoints")
    p.add_argument("--dst_tag", default="avg", help="output checkpoint tag")
    p.add_argument("--num", type=int, default=5)
    p.add_argument("--mode", choices=["best", "last"], default="best")
    p.add_argument("--min_step", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..train.checkpoint import average_checkpoints, save_checkpoint

    state = average_checkpoints(args.src_path, args.num, args.mode, args.min_step)
    save_checkpoint(args.src_path, args.dst_tag, state,
                    info_dict={"averaged": args.num, "mode": args.mode})
    logging.info("wrote averaged checkpoint %s/%s", args.src_path, args.dst_tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
