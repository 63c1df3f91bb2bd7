"""One-command reference-WER gate on chunkformer_tpu_torch (the twin of
tools/eval_reference_wer.py, with the same gates, printout and exit codes).

Reproduces the reference's WER acceptance tests
(reference: tests/test_wer_ctc_performance.py:57-238) on any host with the
checkpoint available: given a local export directory, decode a sample set
through BOTH the endless (long-form) and masked-batch paths, print per-file
hypotheses, aggregate WER, and the endless<->batch consistency metrics, and
exit nonzero if the gates fail.

Gates (same thresholds as the reference test suite):
  - endless WER  < 0.10
  - batch WER    < 0.10
  - |endless WER - batch WER| < 0.01
  - cross-WER(endless vs batch hyps) < 0.01

A Hub id such as khanhld/chunkformer-ctc-large-vie needs the network:
download its files into a directory first and pass that directory. The
reference's own thresholds expect WER well under 10% on both paths for
that model, endless and batch transcripts near-identical.

Usage:
  python tools/eval_torch_reference_wer.py --model <export dir> \
      --data samples/data.tsv [--device cuda|cpu] \
      [--chunk 64 --left 128 --right 128 --total-batch-duration 1800]

The data TSV needs columns (key?)/wav/txt; relative wav paths resolve
against the TSV's parent directory's parent (the reference layout).
"""

import argparse
import csv
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_rows(tsv):
    rows = []
    base = os.path.dirname(os.path.dirname(os.path.abspath(tsv)))
    with open(tsv, encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            wav = row.get("wav") or row.get("audio") or ""
            if not os.path.isabs(wav):
                wav = os.path.join(base, wav)
            rows.append((wav, row.get("txt") or row.get("text") or ""))
    if not rows:
        raise SystemExit(f"no rows in {tsv}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True,
                    help="local export directory (config.yaml, pytorch_model.bin, "
                         "vocab.txt); a Hub id needs the network, so download it "
                         "into a directory first")
    ap.add_argument("--data", required=True, help="TSV with wav/txt columns")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--left", type=int, default=128)
    ap.add_argument("--right", type=int, default=128)
    ap.add_argument("--total-batch-duration", type=int, default=1800,
                    help="seconds of audio per device pass (memory budget)")
    ap.add_argument("--wer-threshold", type=float, default=0.10)
    ap.add_argument("--consistency-threshold", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.decode.outputs import word_error_rate

    rows = load_rows(args.data)
    model = ChunkFormerModel.from_pretrained(args.model, device=torch.device(args.device))

    endless_hyps, refs = [], []
    for wav, txt in rows:
        text = model.endless_decode(
            wav, chunk_size=args.chunk, left_context_size=args.left,
            right_context_size=args.right,
            total_batch_duration=args.total_batch_duration,
            return_timestamps=False)
        endless_hyps.append(text)
        refs.append(txt)
        print(f"[endless] {os.path.basename(wav)}: {text}")

    batch_hyps = model.batch_decode(
        [wav for wav, _ in rows], chunk_size=args.chunk,
        left_context_size=args.left, right_context_size=args.right,
        total_batch_duration=args.total_batch_duration)
    for (wav, _), hyp in zip(rows, batch_hyps):
        print(f"[batch]   {os.path.basename(wav)}: {hyp}")

    wer_endless = word_error_rate(endless_hyps, refs)
    wer_batch = word_error_rate(batch_hyps, refs)
    cross = word_error_rate(batch_hyps, endless_hyps)
    diff = abs(wer_endless - wer_batch)

    print(f"\nendless WER: {wer_endless:.4f}")
    print(f"batch   WER: {wer_batch:.4f}")
    print(f"|endless-batch| WER diff: {diff:.4f}")
    print(f"cross-WER (endless vs batch): {cross:.4f}")

    ok = (wer_endless < args.wer_threshold
          and wer_batch < args.wer_threshold
          and diff < args.consistency_threshold
          and cross < args.consistency_threshold)
    print("GATE:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
