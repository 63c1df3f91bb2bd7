"""Uploaded-media handling (a copy of apps/streamlit/audio_processing.py, so the
twin app imports nothing of the JAX app; reference:
apps/streamlit/audio_processing.py).

Writes the upload to a temp file in chunks with a progress callback (uploads
can be multi-GB for long-form audio) and probes basic media facts for the
stats row.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Optional, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

CHUNK_BYTES = 8 * 1024 * 1024


def save_uploaded_file_with_progress(
    uploaded_file,
    progress_cb: Optional[Callable[[float], None]] = None,
    suffix: Optional[str] = None,
) -> Tuple[str, int]:
    """Stream a Streamlit UploadedFile to disk; returns (path, n_bytes).

    `progress_cb` receives completion in [0, 1] after each chunk.
    """
    if suffix is None:
        suffix = os.path.splitext(getattr(uploaded_file, "name", ""))[1] or ".bin"
    total = getattr(uploaded_file, "size", None)
    written = 0
    fd, path = tempfile.mkstemp(suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as out:
            while True:
                chunk = uploaded_file.read(CHUNK_BYTES)
                if not chunk:
                    break
                out.write(chunk)
                written += len(chunk)
                if progress_cb and total:
                    progress_cb(min(written / total, 1.0))
        if progress_cb:
            progress_cb(1.0)
        return path, written
    except BaseException:
        os.unlink(path)
        raise


def probe_duration_seconds(path: str) -> Optional[float]:
    """Media duration if cheaply determinable (wav header; else ffprobe)."""
    import wave

    try:
        with wave.open(path) as w:
            return w.getnframes() / float(w.getframerate())
    except Exception:
        pass
    try:
        import subprocess

        out = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", path],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except Exception:
        return None
