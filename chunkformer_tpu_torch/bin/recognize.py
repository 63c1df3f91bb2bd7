"""`chunkformer-recognize` batch evaluation CLI (counterpart of
``chunkformer_tpu/bin/recognize.py``; reference: chunkformer/bin/recognize.py:185-309):
decode a test set with one or more strategies, write per-mode hypothesis
files, report WER when references exist.

    python -m chunkformer_tpu_torch.bin.recognize --model_checkpoint <dir> \\
        --test_data test.list --result_dir out --modes ctc_greedy_search attention

A batch of files is padded to its longest, encoded once on ``--device``
(cuda unless named otherwise; at ``--chunk_size`` > 0 through the training
attention's forward kernel) and searched by every mode; the log ends with
the wall seconds of the features and encoder, and of each mode's search.
``--dtype`` picks the model's dtype (fp32 by default, as the JAX CLI's).
``--simulate_streaming`` encodes the batch chunk by chunk through the
encoder's streaming step instead. A transducer export also runs the
``rnnt_*`` modes: batched greedy (8 symbols a frame), the prefix beam with
CTC shallow fusion where the export has a CTC head, and that beam rescored
by the attention decoder where it has one (else the beam's best).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

MODES = ["ctc_greedy_search", "ctc_prefix_beam_search",
         "ctc_prefix_beam_search_batched", "attention", "attention_rescoring",
         # transducer modes (reference: bin/recognize.py:63-72)
         "rnnt_greedy_search", "rnnt_beam_search", "rnnt_beam_attn_rescoring"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ChunkFormer recognition (PyTorch/CUDA)")
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--test_data", required=True, help="TSV/list with wav [txt]")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--modes", nargs="+", default=["ctc_greedy_search"], choices=MODES)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--chunk_size", type=int, default=-1)
    p.add_argument("--left_context_size", type=int, default=-1)
    p.add_argument("--right_context_size", type=int, default=-1)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--reverse_weight", type=float, default=0.0)
    p.add_argument("--blank_penalty", type=float, default=0.0)
    p.add_argument("--context_list", default=None, help="hotword file")
    p.add_argument("--context_score", type=float, default=6.0)
    p.add_argument("--simulate_streaming", action="store_true",
                   help="encode chunk-by-chunk through the streaming step "
                        "(reference: bin/recognize.py --simulate_streaming -> "
                        "encoder.forward_chunk_by_chunk)")
    p.add_argument("--dtype", choices=["fp32", "bf16", "fp16"], default="fp32",
                   help="Device compute dtype (fp16 maps to bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (cuda unless named otherwise)")
    return p.parse_args(argv)


def _streaming_encode(model, xs, lens, c: int, left: int, right: int):
    """Batch chunk-by-chunk encode through the encoder's ``streaming_step``
    (``chunkformer_tpu/bin/recognize.py:46``): the per-layer KV/conv cache
    flow of the realtime app, over a padded feature batch xs [B, T, feat] on
    the model's device. Step s reads raw frames [s*8c, s*8c + frames_in),
    zero past the end, at offset s*c, and keeps its first c outputs.
    Returns (out [B, T', D] in the model's dtype, lengths [B]) on the device.
    """
    import torch

    from ..ops.chunk import calc_length, reverse_calc_length

    cfg = model.config.encoder_conf
    sub = cfg.subsampling_rate
    b, t, f = xs.shape
    encoder = model.model.encoder
    att, cnn = encoder.init_caches(left, model.dtype, model.device, batch=b)
    frames_in = reverse_calc_length(c) + right * sub
    stride = c * sub
    n_out = int(calc_length(t))
    out_parts = []
    with torch.inference_mode():
        for s in range(max(1, -(-n_out // c))):
            win = xs.new_zeros((b, frames_in, f), dtype=model.dtype)
            seg = xs[:, s * stride: s * stride + frames_in]
            win[:, : seg.shape[1]] = seg
            out, att, cnn = encoder.streaming_step(win, att, cnn, c, left, right, s * c)
            out_parts.append(out[:, :c])
    enc_out = torch.cat(out_parts, dim=1)[:, :n_out]
    return enc_out, torch.from_numpy(calc_length(np.asarray(lens))).to(model.device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.simulate_streaming:
        if args.chunk_size <= 0:
            raise SystemExit("--simulate_streaming requires --chunk_size > 0")
        if args.left_context_size < 0 or args.right_context_size < 0:
            # the batch path's -1 = "full context" has no streaming counterpart
            raise SystemExit("--simulate_streaming requires non-negative "
                             "--left_context_size/--right_context_size")

    import torch

    from ..api import ChunkFormerModel
    from ..data.pipeline import text_line_source
    from ..decode.batched_beam import batched_beam_to_results, ctc_prefix_beam_search_batched
    from ..decode.outputs import tokens_to_text, word_error_rate
    from ..decode.search import (DecodeResult, attention_beam_search_device,
                                 attention_rescoring, ctc_greedy_search, ctc_prefix_beam_search)
    from ..models.transducer_search import (transducer_attention_rescoring,
                                            transducer_prefix_beam_search)

    dtype = torch.bfloat16 if args.dtype in ("bf16", "fp16") else torch.float32
    model = ChunkFormerModel.from_pretrained(args.model_checkpoint, dtype=dtype,
                                             device=args.device)
    cfg = model.config
    if any(m.startswith("rnnt_") for m in args.modes) and not model.is_transducer:
        raise SystemExit("the rnnt_* modes need a transducer export (model: transducer)")
    if model.model.ctc is None and any(m.startswith("ctc_") or m == "attention_rescoring"
                                       for m in args.modes):
        raise SystemExit("the CTC modes need an export with a CTC head")
    samples = list(text_line_source(args.test_data))
    os.makedirs(args.result_dir, exist_ok=True)

    context_graph = None
    if args.context_list:
        from ..data.tokenizer import CharTokenizer
        from ..decode.context_graph import ContextGraph

        table = {v: k for k, v in model.char_dict.items()}
        tok = CharTokenizer(table)
        context_graph = ContextGraph.from_file(args.context_list, tok,
                                               args.context_score)

    files = {m: open(os.path.join(args.result_dir, f"{m}.txt"), "w") for m in args.modes}
    hyps_by_mode = {m: [] for m in args.modes}
    refs = []

    seconds = {"encode": 0.0, **{m: 0.0 for m in args.modes}}  # wall time by part
    for i in range(0, len(samples), args.batch_size):
        batch = samples[i:i + args.batch_size]
        t0 = time.perf_counter()
        feats = [model.extract_features(s["wav"]) for s in batch]
        max_t = max(f.shape[0] for f in feats)
        xs = torch.zeros((len(batch), max_t, feats[0].shape[1]), device=model.device)
        for j, f in enumerate(feats):
            xs[j, : f.shape[0]] = f
        lens = torch.tensor([f.shape[0] for f in feats], dtype=torch.int32)
        if args.simulate_streaming:
            enc_out, enc_lens = _streaming_encode(
                model, xs, lens, args.chunk_size, args.left_context_size,
                args.right_context_size)
        else:
            enc_out, enc_lens = model.encode(xs, lens, args.chunk_size,
                                             args.left_context_size, args.right_context_size)
        logp = logp_host = None
        if model.model.ctc is not None:
            logp = model.ctc_logprobs(enc_out)
            if args.blank_penalty != 0.0:
                logp[..., 0] -= args.blank_penalty
            logp_host = logp.cpu().numpy()
        enc_lens_host = enc_lens.cpu().numpy()
        seconds["encode"] += time.perf_counter() - t0

        for mode in args.modes:
            t0 = time.perf_counter()
            if mode == "ctc_greedy_search":
                results = ctc_greedy_search(logp_host, enc_lens_host)
            elif mode == "ctc_prefix_beam_search":
                results = ctc_prefix_beam_search(logp_host, enc_lens_host, args.beam_size,
                                                 context_graph)
            elif mode == "ctc_prefix_beam_search_batched":
                results = batched_beam_to_results(*ctc_prefix_beam_search_batched(
                    logp, enc_lens, args.beam_size))
            elif mode == "attention":
                mask = torch.arange(enc_out.shape[1], device=model.device)[None, :] \
                    < enc_lens[:, None]
                # device beam: one sync a batch instead of one a decode step
                results = attention_beam_search_device(model.model, cfg, enc_out, mask,
                                                       args.beam_size)
            elif mode == "attention_rescoring":
                prefix = ctc_prefix_beam_search(logp_host, enc_lens_host, args.beam_size,
                                                context_graph)
                results = attention_rescoring(model.model, cfg, prefix, enc_out,
                                              enc_lens_host, args.ctc_weight,
                                              args.reverse_weight)
            elif mode == "rnnt_greedy_search":
                results = [DecodeResult(tokens=seq)
                           for seq, _ in model._transducer_greedy(enc_out, enc_lens_host)]
            else:  # rnnt_beam_search / rnnt_beam_attn_rescoring
                results = []
                for bi, n in enumerate(enc_lens_host):
                    enc_b = enc_out[bi, :n]
                    beams = transducer_prefix_beam_search(
                        model.model, cfg, enc_b, args.beam_size,
                        ctc_log_probs=logp_host[bi, :n] if logp_host is not None else None,
                        ctc_weight=args.ctc_weight, blank=cfg.ctc_conf.ctc_blank_id)
                    if mode == "rnnt_beam_attn_rescoring" and model.model.decoder is not None:
                        toks = transducer_attention_rescoring(model.model, cfg, beams, enc_b,
                                                              args.reverse_weight)
                    else:
                        toks = beams[0].hyp[1:] if beams else []
                    results.append(DecodeResult(tokens=toks))
            seconds[mode] += time.perf_counter() - t0   # the results are on the host
            for s, r in zip(batch, results):
                text = tokens_to_text(r.tokens, model.char_dict)
                files[mode].write(f"{s.get('key', s['wav'])}\t{text}\n")
                hyps_by_mode[mode].append(text)
        refs.extend(s.get("txt", "") for s in batch)
        logging.info("decoded %d/%d", min(i + args.batch_size, len(samples)),
                     len(samples))

    logging.info("wall seconds: features and encode %.4f; %s", seconds["encode"],
                 ", ".join(f"{m} {seconds[m]:.4f}" for m in args.modes))
    for mode, f in files.items():
        f.close()
        if any(refs):
            wer = word_error_rate(hyps_by_mode[mode], refs)
            logging.info("%s WER: %.4f", mode, wer)
            with open(os.path.join(args.result_dir, f"{mode}.wer"), "w") as wf:
                wf.write(f"WER: {wer:.4f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
