"""Transcript/timestamp helpers for the app on chunkformer_tpu_torch (the twin
of apps/streamlit/utils.py; reference: apps/streamlit/utils.py).

Timestamps in segment dicts are ``hh:mm:ss:ms`` (the CLI's display format,
reference utils/model_utils.py get_output_with_timestamps); these helpers
convert to/from float seconds and derive subtitle/export artifacts.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from chunkformer_tpu_torch.decode.outputs import (  # noqa: E402
    parse_timestamp,
    segments_to_srt,
    segments_to_vtt,
)


def timestamp_to_seconds(timestamp_str: str) -> float:
    """'hh:mm:ss:ms' -> float seconds (tolerates 'hh:mm:ss.ms')."""
    return parse_timestamp(timestamp_str)


def format_timestamp(seconds: float) -> str:
    """float seconds -> 'hh:mm:ss:ms' (display format of the decode CLI)."""
    ms = int(round(max(seconds, 0.0) * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}:{ms:03d}"


def create_subtitle_srt(segments: List[Dict]) -> str:
    """Segment dicts -> SRT subtitle text."""
    return segments_to_srt(segments)


def create_subtitle_vtt(segments: List[Dict]) -> str:
    """Segment dicts -> WebVTT subtitle text."""
    return segments_to_vtt(segments)


def get_transcript_at_time(segments: List[Dict],
                           current_time: float) -> Optional[Dict]:
    """The segment active at playback time `current_time` (seconds)."""
    for seg in segments:
        start = seg.get("start_time")
        end = seg.get("end_time")
        if start is None:
            start = parse_timestamp(seg["start"])
        if end is None:
            end = parse_timestamp(seg["end"])
        if start <= current_time < end:
            return seg
        if start > current_time:
            break
    return None


def transcript_stats(segments: List[Dict]) -> Dict:
    """Word/segment/duration summary shown above the transcript."""
    words = sum(len((s.get("decode") or "").split()) for s in segments)
    if segments:
        last = segments[-1]
        end = last.get("end_time")
        if end is None:
            end = parse_timestamp(last["end"])
    else:
        end = 0.0
    return {"segments": len(segments), "words": words,
            "speech_end": float(end)}


def plain_transcript(segments: List[Dict], with_times: bool = True) -> str:
    if with_times:
        return "\n".join(f"[{s['start']} - {s['end']}] {s['decode']}"
                         for s in segments)
    return " ".join((s.get("decode") or "").strip() for s in segments).strip()


# mime helpers live in ui_components; re-export under the reference's name
from ui_components import guess_mime as guess_video_mime_type  # noqa: E402,F401
