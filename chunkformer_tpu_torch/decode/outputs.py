"""CTC output post-processing: text assembly and timestamping.

A copy of ``chunkformer_tpu/decode/outputs.py`` (numpy only), limited to what
CTC decoding and the CLIs use (reference: chunkformer/utils/model_utils.py:23-222):
collapse frame-level token ids, derive per-token peak times, segment
long-form transcripts at silence gaps (each subsampled frame is 80 ms),
subtitles, and the word error rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

FRAME_SECONDS = 0.08  # 8x subsampling of 10 ms frames (model_utils.py:189)


def format_timestamp(seconds: float) -> str:
    """hh:mm:ss:ms (reference model_utils.py:140-161)."""
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}:{ms:03d}"


def parse_timestamp(stamp: str) -> float:
    """Inverse of format_timestamp: "hh:mm:ss:ms" -> seconds."""
    h, m, s, ms = (int(x) for x in stamp.split(":"))
    return h * 3600 + m * 60 + s + ms / 1000.0


def _subtitle_time(seconds: float, sep: str) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def segments_to_srt(segments) -> str:
    """Timestamped segments -> SubRip subtitles."""
    lines = []
    for i, seg in enumerate(segments, start=1):
        start = parse_timestamp(seg["start"])
        end = parse_timestamp(seg["end"])
        lines.append(f"{i}\n{_subtitle_time(start, ',')} --> "
                     f"{_subtitle_time(end, ',')}\n{seg['decode']}\n")
    return "\n".join(lines)


def segments_to_vtt(segments) -> str:
    """Timestamped segments -> WebVTT subtitles."""
    lines = ["WEBVTT\n"]
    for seg in segments:
        start = parse_timestamp(seg["start"])
        end = parse_timestamp(seg["end"])
        lines.append(f"{_subtitle_time(start, '.')} --> "
                     f"{_subtitle_time(end, '.')}\n{seg['decode']}\n")
    return "\n".join(lines)


@dataclasses.dataclass
class Segment:
    decode: str
    start: str
    end: str

    def as_dict(self) -> Dict:
        return {"decode": self.decode, "start": self.start, "end": self.end}


def collapse_with_times(frame_tokens: Sequence[int], blank: int = 0):
    """CTC collapse returning (tokens, peak_frame_indices).

    Peak time for a token run is its first frame (reference
    model_utils.py:48-57 gen_ctc_peak_time).
    """
    tokens, times = [], []
    prev = None
    for i, tok in enumerate(frame_tokens):
        tok = int(tok)
        if tok != blank and tok != prev:
            tokens.append(tok)
            times.append(i)
        prev = tok
    return tokens, times


def tokens_to_text(tokens: Sequence[int], char_dict: Dict[int, str]) -> str:
    """Join symbols, mapping the BPE space marker to a space."""
    text = "".join(char_dict.get(int(t), "") for t in tokens)
    return text.replace("▁", " ").strip()


def get_output(hyps: Sequence[Sequence[int]], char_dict: Dict[int, str],
               blank: int = 0) -> List[str]:
    """CTC frame-token sequences -> transcripts (reference model_utils.py:164-172)."""
    return [tokens_to_text(collapse_with_times(h, blank)[0], char_dict) for h in hyps]


def segments_from_tokens(
    tokens: Sequence[int],
    times: Sequence[int],
    char_dict: Dict[int, str],
    max_silence_duration: float = 0.5,
) -> List[Dict]:
    """Silence-gap segmentation of an already-collapsed (token, frame) stream
    (model_utils.py:174-222)."""
    if not tokens:
        return []
    max_gap_frames = max_silence_duration / FRAME_SECONDS

    segments: List[Segment] = []
    seg_tokens = [tokens[0]]
    seg_start = times[0]
    prev_time = times[0]
    for tok, tm in zip(tokens[1:], times[1:]):
        if tm - prev_time >= max_gap_frames:
            segments.append(_make_segment(seg_tokens, seg_start, prev_time, char_dict))
            seg_tokens = [tok]
            seg_start = tm
        else:
            seg_tokens.append(tok)
        prev_time = tm
    segments.append(_make_segment(seg_tokens, seg_start, prev_time, char_dict))
    return [s.as_dict() for s in segments]


def get_output_with_timestamps(
    frame_tokens: Sequence[int],
    char_dict: Dict[int, str],
    max_silence_duration: float = 0.5,
    blank: int = 0,
) -> List[Dict]:
    """CTC frame stream -> silence-segmented transcript with timestamps."""
    tokens, times = collapse_with_times(frame_tokens, blank)
    return segments_from_tokens(tokens, times, char_dict, max_silence_duration)


def _make_segment(tokens, start_frame, end_frame, char_dict) -> Segment:
    return Segment(
        decode=tokens_to_text(tokens, char_dict),
        start=format_timestamp(start_frame * FRAME_SECONDS),
        end=format_timestamp((end_frame + 1) * FRAME_SECONDS),
    )


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance for WER computation."""
    if len(a) < len(b):
        a, b = b, a
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def word_error_rate(hyps: Sequence[str], refs: Sequence[str]) -> float:
    """Corpus-level WER over whitespace tokens."""
    errors, total = 0, 0
    for h, r in zip(hyps, refs):
        hw, rw = h.split(), r.split()
        errors += levenshtein(hw, rw)
        total += len(rw)
    return errors / max(total, 1)
