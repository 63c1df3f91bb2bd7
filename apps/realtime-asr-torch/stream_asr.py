"""Realtime mic/file streaming ASR on chunkformer_tpu_torch (the twin of
apps/realtime-asr/stream_asr.py; reference: apps/realtime-asr/stream_asr.py).

Thin app-layout shim over the port's implementation: the stateful
incremental decoder lives in ``chunkformer_tpu_torch.bin.stream.StreamingASR``
(per-layer KV/conv caches + 85 ms audio overlap, the features on the card's
fbank kernel), capture backends in ``chunkformer_tpu_torch.data.capture``.
``RealtimeASR`` is the reference's class name with its run-loop surface.

Usage (on the card; add --device cpu to run on the CPU):
    python apps/realtime-asr-torch/stream_asr.py --model_checkpoint <dir> --mic
    python apps/realtime-asr-torch/stream_asr.py --model_checkpoint <dir> \\
        --audio_file clip.wav --speed 1.0
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from chunkformer_tpu_torch.bin.stream import StreamingASR, main, parse_args  # noqa: E402,F401
from chunkformer_tpu_torch.data.capture import open_capture  # noqa: E402


class RealtimeASR(StreamingASR):
    """Reference-named class: StreamingASR plus a capture-driven run loop
    (reference stream_asr.py:22 RealtimeASR.run:206)."""

    def run(self, source: str = "mic", device=None, speed: float = 0.0,
            on_update=None) -> str:
        """Capture from `source` ('mic' or a file path; `device` is the
        microphone's input device index), decode until the stream ends or
        Ctrl-C; returns the final transcript. `on_update` (text,
        audio_seconds, rtf) fires after each accepted chunk."""
        cap = open_capture(source, sample_rate=self.sr,
                           chunk_samples=self.step_samples,
                           device=device, speed=speed)
        t0 = time.perf_counter()
        audio_s = 0.0
        with cap:
            try:
                for chunk in cap:
                    audio_s += len(chunk) / self.sr
                    self.accept_audio(chunk)
                    if on_update:
                        rtf = (time.perf_counter() - t0) / max(audio_s, 1e-9)
                        on_update(self.text(), audio_s, rtf)
            except KeyboardInterrupt:
                pass
        return self.text()


if __name__ == "__main__":
    sys.exit(main())
