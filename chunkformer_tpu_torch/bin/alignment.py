"""`chunkformer-align` CLI (counterpart of ``chunkformer_tpu/bin/alignment.py``;
reference: chunkformer/bin/alignment.py): CTC forced alignment of
audio + transcript -> Praat TextGrid, on ``--device`` (cuda unless named
otherwise).

    python -m chunkformer_tpu_torch.bin.alignment --model_checkpoint <dir> \\
        --input_file list.tsv --result_dir out
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ChunkFormer forced alignment (PyTorch/CUDA)")
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--input_file", required=True, help="TSV: key wav txt")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (cuda unless named otherwise)")
    return p.parse_args(argv)


def write_textgrid(path: str, intervals, total_dur: float):
    """Minimal Praat TextGrid writer (bin/alignment.py output format)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write('File type = "ooTextFile"\nObject class = "TextGrid"\n\n')
        f.write(f"xmin = 0\nxmax = {total_dur}\ntiers? <exists>\nsize = 1\n")
        f.write("item []:\n    item [1]:\n")
        f.write('        class = "IntervalTier"\n        name = "tokens"\n')
        f.write(f"        xmin = 0\n        xmax = {total_dur}\n")
        f.write(f"        intervals: size = {len(intervals)}\n")
        for i, (start, end, label) in enumerate(intervals, 1):
            f.write(f"        intervals [{i}]:\n")
            f.write(f"            xmin = {start}\n            xmax = {end}\n")
            f.write(f'            text = "{label}"\n')


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..api import ChunkFormerModel
    from ..data.pipeline import text_line_source
    from ..data.tokenizer import CharTokenizer
    from ..ops.ctc import ctc_forced_align

    model = ChunkFormerModel.from_pretrained(args.model_checkpoint, device=args.device)
    table = {v: k for k, v in model.char_dict.items()}
    tokenizer = CharTokenizer(table)
    os.makedirs(args.result_dir, exist_ok=True)

    frame_s = 0.08
    for s in text_line_source(args.input_file):
        feats = model.extract_features(s["wav"])
        enc_out, enc_lens = model.encode(feats[None], [feats.shape[0]])
        logp = model.ctc_logprobs(enc_out)[0]
        t_len = int(enc_lens[0])
        _, ids = tokenizer.tokenize(s["txt"])
        states = ctc_forced_align(logp[:t_len], ids, t_len)
        # group consecutive frames into intervals
        intervals = []
        start = 0
        for t in range(1, t_len + 1):
            if t == t_len or states[t] != states[t - 1]:
                label = model.char_dict.get(int(states[t - 1]), "")
                if int(states[t - 1]) == 0:
                    label = ""
                intervals.append((start * frame_s, t * frame_s, label))
                start = t
        out = os.path.join(args.result_dir, f"{s.get('key', 'utt')}.TextGrid")
        write_textgrid(out, intervals, t_len * frame_s)
        logging.info("aligned %s -> %s", s.get("key"), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
