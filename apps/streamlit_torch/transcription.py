"""Model loading + transcription wrapper on chunkformer_tpu_torch (the twin of
apps/streamlit/transcription.py; reference: apps/streamlit/transcription.py).

Caches the loaded model per (directory, device) and runs `endless_decode`
with wall-time accounting; returns (segments, info) where info carries the numbers shown in
the results header (elapsed, RTFx, decoded duration).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

_MODEL_CACHE: Dict[Tuple[str, str], object] = {}


def load_model(model_path: str, device: str = "cuda"):
    """Load (and cache) a ChunkFormer model from a local export dir onto
    `device` (the card unless "cpu" is named; a Hub repo needs downloading
    into a directory first). Reference transcription.py:18 caches the same
    way via st.cache_resource; this cache also works outside Streamlit."""
    key = (model_path, str(device))
    if key not in _MODEL_CACHE:
        from chunkformer_tpu_torch.api import ChunkFormerModel

        _MODEL_CACHE[key] = ChunkFormerModel.from_pretrained(model_path, device=device)
    return _MODEL_CACHE[key]


def transcribe_audio(
    model,
    audio_path: str,
    chunk_size: int = 64,
    left_context_size: int = 128,
    right_context_size: int = 128,
    total_batch_duration: int = 1800,
    max_silence_duration: float = 0.5,
) -> Tuple[List[Dict], Dict]:
    """Long-form transcription -> (timestamped segments, run info)."""
    t0 = time.perf_counter()
    segments = model.endless_decode(
        audio_path,
        chunk_size=int(chunk_size),
        left_context_size=int(left_context_size),
        right_context_size=int(right_context_size),
        total_batch_duration=int(total_batch_duration),
        return_timestamps=True,
        max_silence_duration=float(max_silence_duration),
    )
    elapsed = time.perf_counter() - t0
    from utils import transcript_stats

    stats = transcript_stats(segments)
    info = {
        "elapsed_s": elapsed,
        "segments": stats["segments"],
        "words": stats["words"],
        "speech_end_s": stats["speech_end"],
        "rtfx": (stats["speech_end"] / elapsed) if elapsed > 0 else 0.0,
    }
    return segments, info
