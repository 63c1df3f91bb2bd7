"""Realtime streaming ASR (counterpart of ``chunkformer_tpu/bin/stream.py``;
reference: apps/realtime-asr/stream_asr.py).

Decodes audio incrementally through the encoder's ``streaming_step`` with
per-layer KV/conv caches: one step per `chunk_size` subsampled frames (~chunk*80 ms),
with an 85 ms raw-audio overlap cache feeding the fbank so subsampling context
is exact (stream_asr.py:38-40). Prints the incremental transcript and RTF.

    python -m chunkformer_tpu_torch.bin.stream --model_checkpoint <dir> \\
        --audio_file <wav> [--device cpu]

Modes: --audio_file simulates realtime from a file (testable without a mic);
--mic uses sounddevice or PyAudio when available. The model and the features
run on ``--device`` (cuda unless named otherwise), in ``--dtype`` (fp32 by
default, as the JAX CLI's); the microphone's input device index, ``--device``
in the JAX CLI, is ``--input_device`` here. Audio shorter than one step at the
end of the stream is not decoded, as in the JAX CLI (ROADMAP C10).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ChunkFormer realtime streaming (PyTorch/CUDA)")
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--audio_file", default=None, help="simulate streaming from file")
    p.add_argument("--mic", action="store_true", help="capture from microphone")
    p.add_argument("--input_device", type=int, default=None, help="input device index")
    p.add_argument("--list_devices", action="store_true",
                   help="list input devices and exit")
    p.add_argument("--speed", type=float, default=0.0,
                   help="file replay pace: 1.0 = realtime, 0 = as fast as possible")
    p.add_argument("--chunk_size", type=int, default=6,
                   help="subsampled frames per step (6 ~= 480 ms)")
    p.add_argument("--left_context_size", type=int, default=50)
    p.add_argument("--right_context_size", type=int, default=0)
    p.add_argument("--dtype", choices=["fp32", "bf16", "fp16"], default="fp32",
                   help="Device compute dtype (fp16 maps to bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (cuda unless named otherwise)")
    return p.parse_args(argv)


class StreamingASR:
    """Stateful incremental decoder over the encoder's ``streaming_step``.

    ``step_seconds`` holds the host wall time of each step, from its
    features to its tokens on the host (so it includes the device's work).
    """

    AUDIO_CACHE_MS = 85  # subsampling context overlap (stream_asr.py:38-40)

    def __init__(self, model, chunk_size=6, left_context=50, right_context=0):
        from ..ops.chunk import reverse_calc_length

        self.model = model
        self.c, self.L, self.R = chunk_size, left_context, right_context
        self.sr = 16000
        self.cache_samples = int(self.AUDIO_CACHE_MS * self.sr / 1000)
        # raw samples consumed per step: stride c*8 frames = c*8*160 samples
        self.step_samples = self.c * 8 * 160
        # frames needed per step: reverse_calc_length(c) + R*8 (+ window tail)
        self.frames_in = reverse_calc_length(self.c) + self.R * 8
        self.att_cache, self.cnn_cache = model.model.encoder.init_caches(
            self.L, model.dtype, model.device, batch=1)
        self.offset = 0
        self.audio_buffer = np.zeros(0, np.float32)
        self.tokens = []
        self.step_seconds = []

    @torch.inference_mode()
    def accept_audio(self, samples: np.ndarray):
        """Feed raw float32 PCM (int16 scale); returns newly final text tokens."""
        from ..ops.fbank import fbank

        model = self.model
        self.audio_buffer = np.concatenate([self.audio_buffer, samples])
        new_tokens = []
        need = self.cache_samples + (self.frames_in - 1) * 160 + 400
        while self.audio_buffer.shape[0] >= need:
            t0 = time.perf_counter()
            window = torch.from_numpy(self.audio_buffer[:need]).to(model.device)
            feats = fbank(window)[self.cache_samples // 160:][: self.frames_in]
            out, self.att_cache, self.cnn_cache = model.model.encoder.streaming_step(
                feats[None].to(model.dtype), self.att_cache, self.cnn_cache,
                self.c, self.L, self.R, self.offset)
            toks = model.model.ctc.argmax(out[0, : self.c]).tolist()  # final part only
            self.step_seconds.append(time.perf_counter() - t0)
            new_tokens.extend(toks)
            self.offset += self.c
            self.audio_buffer = self.audio_buffer[self.step_samples:]
        self.tokens.extend(new_tokens)
        return new_tokens

    def text(self) -> str:
        from ..decode.outputs import get_output

        if self.model.char_dict is None:
            return " ".join(map(str, self.tokens))
        return get_output([self.tokens], self.model.char_dict)[0]


def main(argv=None):
    args = parse_args(argv)
    from ..data.capture import list_input_devices, open_capture

    if args.list_devices:
        devices = list_input_devices()
        if not devices:
            print("no input devices (or no capture backend installed)")
        for i, name in devices:
            print(f"{i}\t{name}")
        return 0

    from ..api import ChunkFormerModel

    dtype = torch.bfloat16 if args.dtype in ("bf16", "fp16") else torch.float32
    model = ChunkFormerModel.from_pretrained(args.model_checkpoint, dtype=dtype,
                                             device=args.device)
    asr = StreamingASR(model, args.chunk_size, args.left_context_size,
                       args.right_context_size)

    if not args.audio_file and not args.mic:
        print("need --audio_file or --mic", file=sys.stderr)
        return 2
    source = "mic" if args.mic else args.audio_file
    try:
        cap = open_capture(source, sample_rate=asr.sr,
                           chunk_samples=asr.step_samples,
                           device=args.input_device, speed=args.speed)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    audio_s = 0.0
    with cap:
        try:
            for chunk in cap:
                audio_s += len(chunk) / asr.sr
                asr.accept_audio(chunk)
                elapsed = time.perf_counter() - t_start
                rtf = elapsed / max(audio_s, 1e-9)
                print(f"\r[{audio_s:6.1f}s RTF={rtf:.3f}] {asr.text()}",
                      end="", flush=True)
        except KeyboardInterrupt:
            pass
    print()
    print("final:", asr.text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
