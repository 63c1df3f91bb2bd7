#!/usr/bin/env python3
"""Where the host time of the port's long-form walk goes, phase by phase
(counterpart of ``tools/bench_endless_breakdown.py``).

    python3 tools/bench_torch_endless_breakdown.py [--seconds 2040] [--trials 3] [--json out.json]

ChunkFormer-large in bf16 (random weights from
``utils/params.py:random_params_like``) at (64, 128, 128) with an 1800 s
budget, on ``--seconds`` of the smoke run's synthetic speech written as a
WAV. First the link: a small copy's round trip (8 x 128 floats to the
device, one add, back) and the pinned upload of the file's int8 features
(CUDA events, GB/s). Then the features: ``extract_features`` (the fbank
kernel) and their fetch to the host. Then ``--trials`` walks of
``ChunkFormerModel._endless_segments`` (``api.py``) over the host features,
as ``endless_encode_tokens`` runs it (a warm-up walk first), with each host
phase timed by wrapping it inside this tool:

- quantize: ``FeatureUpload`` construction (the host library's int8
  quantize with one global scale, the pinned staging, the device buffer);
- upload: ``FeatureUpload.wait`` and ``prefetch`` (queueing each segment's
  new frames on the side stream, the wait on its event);
- pack: ``ops/chunk.py`` ``device_pack_segment``;
- encoder: the ``parallel_chunk`` dispatch;
- segment: the callback (the CTC argmax and the keep slice);
- final sync: the tokens' copy to the host that waits for the device.

Each segment's device time (encoder and callback) comes from CUDA events.
Prints a line per trial and one JSON object; ``--json PATH`` writes it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C, LEFT, RIGHT = 64, 128, 128
PHASES = ("quantize", "upload", "pack", "encoder", "segment", "final sync")


class PhaseClock:
    """Host seconds by phase of wrapped callables; a call made inside
    another timed call counts only for the outer one (``wait`` calls
    ``prefetch``)."""

    def __init__(self):
        self.seconds = dict.fromkeys(PHASES, 0.0)
        self._busy = False

    def wrap(self, phase, fn):
        def timed(*args, **kwargs):
            if self._busy:
                return fn(*args, **kwargs)
            self._busy = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[phase] += time.perf_counter() - t0
                self._busy = False
        return timed


@contextlib.contextmanager
def instrumented(model, clock: PhaseClock, marks: list):
    """The walk's phases wrapped by ``clock``, a CUDA event recorded into
    ``marks`` before each encoder call on the card; the originals back on
    exit."""
    from chunkformer_tpu_torch import api
    from chunkformer_tpu_torch.ops import chunk as chunk_ops

    encoder = type(model.model.encoder)
    dispatch = encoder.parallel_chunk

    def encode(self, *args, **kwargs):
        if model.device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        return dispatch(self, *args, **kwargs)

    targets = [(api.FeatureUpload, "__init__", "quantize", api.FeatureUpload.__init__),
               (api.FeatureUpload, "wait", "upload", api.FeatureUpload.wait),
               (api.FeatureUpload, "prefetch", "upload", api.FeatureUpload.prefetch),
               (chunk_ops, "device_pack_segment", "pack", chunk_ops.device_pack_segment),
               (encoder, "parallel_chunk", "encoder", encode)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _, _ in targets]
    try:
        for owner, name, phase, fn in targets:
            setattr(owner, name, clock.wrap(phase, fn))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def link(feats_host: np.ndarray, device: torch.device):
    """(a small copy's round trip in ms, the pinned int8 upload's bytes and GB/s)."""
    from chunkformer_tpu_torch.api import quantize_int8

    x = torch.zeros(8, 128)
    (x.to(device) + 1).cpu()
    t0 = time.perf_counter()
    (x.to(device) + 1).cpu()
    rtt_ms = (time.perf_counter() - t0) * 1e3
    q, _ = quantize_int8(feats_host)
    q = torch.from_numpy(q)
    if device.type != "cuda":
        return rtt_ms, q.numel(), None
    q = q.pin_memory()
    dst = torch.empty_like(q, device=device)
    dst.copy_(q, non_blocking=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    dst.copy_(q, non_blocking=True)
    end.record()
    end.synchronize()
    return rtt_ms, q.numel(), q.numel() / (start.elapsed_time(end) * 1e-3) / 1e9


@torch.inference_mode()
def walk(model, feats_host, budget: int, clock: PhaseClock):
    """One ``endless_encode_tokens`` walk of host features with its phases
    timed: (frame tokens, total seconds, device ms a segment or None)."""
    cuda = model.device.type == "cuda"
    marks = []

    def segment(out, keep):
        tokens = model.model.ctc.argmax(out).reshape(-1)[:keep]
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        return tokens

    t0 = time.perf_counter()
    with instrumented(model, clock, marks):
        parts = model._endless_segments(feats_host, C, LEFT, RIGHT, budget,
                                        clock.wrap("segment", segment))
        t1 = time.perf_counter()
        tokens = torch.cat(parts).cpu().numpy()
        clock.seconds["final sync"] += time.perf_counter() - t1
    total = time.perf_counter() - t0
    device_ms = ([a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])] if cuda
                 else None)
    return tokens, total, device_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=2040.0, help="audio of the file")
    ap.add_argument("--budget", type=int, default=1800, help="total_batch_duration")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--num_blocks", type=int, default=17)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    from chip_smoke import card_name, scaled_large, speechlike, write_wav
    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.utils.params import random_params_like

    cfg = ChunkFormerConfig.from_dict(scaled_large(args.d_model, args.num_blocks))
    model = ChunkFormerModel(cfg, random_params_like(ASRModel(cfg)).state_dict(),
                             dtype=torch.bfloat16, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory() as root:
        wav = os.path.join(root, "long.wav")
        write_wav(wav, speechlike(np.random.default_rng(0), args.seconds))
        model.extract_features(wav)
        sync()
        t0 = time.perf_counter()
        feats = model.extract_features(wav)
        sync()
        t1 = time.perf_counter()
        feats_host = feats.cpu().numpy()
        t2 = time.perf_counter()
    rtt_ms, upload_bytes, upload_gb_s = link(feats_host, device)
    print(f"link: round trip {rtt_ms:.3f} ms; pinned upload of {upload_bytes / 1e6:.1f} MB "
          f"int8 at {upload_gb_s if upload_gb_s is None else round(upload_gb_s, 2)} GB/s; "
          f"features {t1 - t0:.4f} s ({feats.shape[0]} frames), fetched in {t2 - t1:.4f} s",
          flush=True)

    walk(model, feats_host, args.budget, PhaseClock())  # warm-up
    trials = []
    for trial in range(args.trials):
        clock = PhaseClock()
        _, total, device_ms = walk(model, feats_host, args.budget, clock)
        trials.append({"total_s": total, "audio_s_per_s": args.seconds / total,
                       "phases_s": clock.seconds, "device_ms_per_segment": device_ms})
        phases = ", ".join(f"{k} {v:.4f}" for k, v in clock.seconds.items())
        print(f"trial {trial}: total {total:.4f} s ({args.seconds / total:.1f} audio-s/s) | "
              f"{phases} | device ms a segment {device_ms}", flush=True)
    out = {"device": card_name(device), "audio_s": args.seconds, "budget": args.budget,
           "chunk": [C, LEFT, RIGHT], "frames": int(feats_host.shape[0]),
           "features_s": t1 - t0, "fetch_s": t2 - t1,
           "link": {"round_trip_ms": rtt_ms, "upload_bytes": upload_bytes,
                    "pinned_upload_gb_s": upload_gb_s},
           "trials": trials}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
