"""App configuration of the chunkformer_tpu_torch transcription UI (a copy of
apps/streamlit/config.py; reference: apps/streamlit/config.py).

Central constants for the transcription UI; name the model with the
`-- --model_checkpoint <dir>` CLI arg.
"""

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class AppConfig:
    page_title: str = "ChunkFormer transcription (PyTorch/CUDA)"
    page_icon: str = "🎙️"
    layout: str = "wide"

    # media
    supported_formats: Tuple[str, ...] = (
        "wav", "mp3", "flac", "mp4", "m4a", "ogg", "webm", "mov")
    max_upload_mb: int = 4096  # long-form is the point

    # default decode parameters (reference defaults: chunk 64, L/R 128)
    chunk_size: int = 64
    left_context_size: int = 128
    right_context_size: int = 128
    total_batch_duration: int = 1800
    max_silence_duration: float = 0.5

    # player
    player_height: int = 560

    # sample rates the pipeline accepts before resampling kicks in
    target_sample_rate: int = 16000

    presets: List[Tuple[str, int, int, int]] = field(default_factory=lambda: [
        # (name, chunk, left, right)
        ("Accurate (full context)", 64, 128, 128),
        ("Balanced", 64, 64, 64),
        ("Low memory", 32, 64, 64),
    ])


APP_CONFIG = AppConfig()
