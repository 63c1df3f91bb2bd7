"""Streamlit UI components: synchronized subtitle/video player (the twin of
apps/streamlit/ui_components.py on chunkformer_tpu_torch).

Behavioral counterpart of the reference's synced transcript player
(reference: apps/streamlit/ui_components.py:380 render_synchronized_player):
an HTML component pairing a <video>/<audio> element with a scrollable
transcript pane. JS on `timeupdate` highlights the active segment and
auto-scrolls it into view; clicking a segment seeks the media. Written from
scratch around our segment dicts ({"decode", "start", "end"} with
hh:mm:ss:ms stamps).
"""

from __future__ import annotations

import base64
import html
import json
import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from chunkformer_tpu_torch.decode.outputs import parse_timestamp  # noqa: E402


def prepare_segments_for_player(segments: List[Dict]) -> List[Dict]:
    """Segment dicts -> [{"start": s, "end": s, "text": str}] with float
    seconds, dropping empties and enforcing monotonic non-overlap."""
    out = []
    prev_end = 0.0
    for seg in segments:
        text = (seg.get("decode") or "").strip()
        if not text:
            continue
        start = seg.get("start_time")
        end = seg.get("end_time")
        if start is None:
            start = parse_timestamp(seg["start"])
        if end is None:
            end = parse_timestamp(seg["end"])
        start = max(float(start), prev_end)
        end = max(float(end), start)
        prev_end = end
        out.append({"start": round(start, 3), "end": round(end, 3),
                    "label": seg.get("start", ""), "text": text})
    return out


def _player_html(media_b64: str, mime_type: str, segments_json: str,
                 height: int) -> str:
    tag = "audio" if mime_type.startswith("audio/") else "video"
    return f"""
<style>
  .cf-sync {{ display: flex; gap: 1rem; font-family: system-ui, sans-serif; }}
  .cf-media {{ flex: 3 1 360px; min-width: 280px; }}
  .cf-media {tag} {{ width: 100%; border-radius: 8px; display: block; }}
  .cf-transcript {{ flex: 2 1 260px; overflow-y: auto; max-height: {height - 40}px;
                   border: 1px solid #d0d4dc; border-radius: 8px; padding: 6px; }}
  .cf-seg {{ padding: 6px 8px; border-radius: 6px; cursor: pointer;
            margin-bottom: 2px; line-height: 1.35; }}
  .cf-seg:hover {{ background: #eef1f7; }}
  .cf-seg.active {{ background: #dde6ff; font-weight: 600; }}
  .cf-seg .t {{ font-size: 0.75em; color: #667; margin-right: 6px;
               font-variant-numeric: tabular-nums; }}
</style>
<div class="cf-sync">
  <div class="cf-media">
    <{tag} id="cf-player" controls src="data:{mime_type};base64,{media_b64}"></{tag}>
  </div>
  <div class="cf-transcript" id="cf-transcript"></div>
</div>
<script>
  const segments = {segments_json};
  const player = document.getElementById("cf-player");
  const pane = document.getElementById("cf-transcript");
  segments.forEach((seg, i) => {{
    const div = document.createElement("div");
    div.className = "cf-seg";
    div.id = "cf-seg-" + i;
    const t = document.createElement("span");
    t.className = "t";
    t.textContent = seg.label;
    div.appendChild(t);
    div.appendChild(document.createTextNode(seg.text));
    div.addEventListener("click", () => {{
      player.currentTime = seg.start + 0.01;
      player.play();
    }});
    pane.appendChild(div);
  }});
  let active = -1;
  player.addEventListener("timeupdate", () => {{
    const t = player.currentTime;
    let idx = -1;
    for (let i = 0; i < segments.length; i++) {{
      if (t >= segments[i].start && t < segments[i].end) {{ idx = i; break; }}
      if (segments[i].start > t) break;
    }}
    if (idx === active) return;
    if (active >= 0)
      document.getElementById("cf-seg-" + active).classList.remove("active");
    active = idx;
    if (idx >= 0) {{
      const el = document.getElementById("cf-seg-" + idx);
      el.classList.add("active");
      el.scrollIntoView({{ block: "nearest", behavior: "smooth" }});
    }}
  }});
</script>
"""


def render_synchronized_player(media_bytes: bytes, mime_type: str,
                               segments: List[Dict], height: int = 560) -> None:
    """Render the synced player inside Streamlit."""
    import streamlit as st
    import streamlit.components.v1 as components

    prepared = prepare_segments_for_player(segments)
    if not media_bytes or not prepared:
        st.warning("Nothing to synchronize: missing media or empty transcript.")
        return
    safe = [{**p, "text": html.escape(p["text"]), "label": html.escape(p["label"])}
            for p in prepared]
    components.html(
        _player_html(base64.b64encode(media_bytes).decode("ascii"), mime_type,
                     json.dumps(safe, ensure_ascii=False), height),
        height=height, scrolling=False)


MIME_BY_EXT = {
    ".mp4": "video/mp4", ".m4a": "audio/mp4", ".webm": "video/webm",
    ".mov": "video/quicktime", ".wav": "audio/wav", ".mp3": "audio/mpeg",
    ".flac": "audio/flac", ".ogg": "audio/ogg",
}


def guess_mime(filename: str) -> str:
    return MIME_BY_EXT.get(os.path.splitext(filename)[1].lower(),
                           "application/octet-stream")


# --------------------------------------------------------------- page chrome
# (reference app has render_custom_css/hero/landing/footer,
#  apps/streamlit/ui_components.py:14,724,792,1238 — same roles, our styling)

CUSTOM_CSS = """
<style>
  .block-container { padding-top: 1.2rem; }
  .cf-hero {
    padding: 1.4rem 1.6rem; border-radius: 12px; margin-bottom: 1rem;
    background: linear-gradient(120deg, #101b33 0%, #1f3a63 100%);
    color: #f4f7ff;
  }
  .cf-hero h1 { margin: 0 0 0.3rem 0; font-size: 1.7rem; color: #f4f7ff; }
  .cf-hero p  { margin: 0; opacity: 0.85; }
  .cf-badges span {
    display: inline-block; margin: 0.5rem 0.4rem 0 0; padding: 2px 10px;
    font-size: 0.75rem; border-radius: 999px; background: #ffffff22;
  }
  .cf-stat {
    border: 1px solid #e2e6ee; border-radius: 10px; padding: 0.6rem 0.9rem;
    text-align: center;
  }
  .cf-stat .v { font-size: 1.25rem; font-weight: 700; }
  .cf-stat .k { font-size: 0.75rem; color: #66708a; text-transform: uppercase;
                letter-spacing: 0.04em; }
  .cf-feature { border-left: 3px solid #4a79d9; padding-left: 0.8rem;
                margin-bottom: 0.8rem; }
  .cf-footer { margin-top: 2rem; padding-top: 0.8rem; font-size: 0.8rem;
               color: #66708a; border-top: 1px solid #e2e6ee; }
</style>
"""


def render_custom_css() -> None:
    import streamlit as st

    st.markdown(CUSTOM_CSS, unsafe_allow_html=True)


def render_hero_section() -> None:
    import streamlit as st

    st.markdown(
        """
<div class="cf-hero">
  <h1>ChunkFormer-TPU — long-form transcription</h1>
  <p>Hours of audio in one pass: chunked attention with exact right context,
     masked batching, timestamped segments.</p>
  <div class="cf-badges">
    <span>up to 16 h / file</span><span>word timestamps</span>
    <span>SRT / VTT export</span><span>TPU-native (JAX)</span>
  </div>
</div>
""",
        unsafe_allow_html=True)


def render_landing_page() -> None:
    """Shown before any file is uploaded."""
    import streamlit as st

    c1, c2, c3 = st.columns(3)
    for col, (title, body) in zip((c1, c2, c3), (
        ("1 · Point at a model",
         "A local export directory (config.yaml + weights + vocab) or a "
         "Hugging Face repo id in the sidebar."),
        ("2 · Upload media",
         "Audio or video — wav, mp3, flac, mp4, m4a, ogg, webm, mov. "
         "Long files are streamed through the encoder in bounded-memory "
         "segments."),
        ("3 · Browse & export",
         "Playback-synchronized transcript with click-to-seek, full-text "
         "search, and TXT/SRT/VTT downloads."),
    )):
        with col:
            st.markdown(f'<div class="cf-feature"><b>{title}</b><br/>{body}'
                        "</div>", unsafe_allow_html=True)


def render_stats_row(stats: dict) -> None:
    """Small metric tiles above the transcript."""
    import streamlit as st

    cols = st.columns(len(stats))
    for col, (k, v) in zip(cols, stats.items()):
        col.markdown(f'<div class="cf-stat"><div class="v">{v}</div>'
                     f'<div class="k">{html.escape(str(k))}</div></div>',
                     unsafe_allow_html=True)


def render_footer() -> None:
    import streamlit as st

    st.markdown(
        '<div class="cf-footer">ChunkFormer-TPU · chunked-attention ASR '
        "framework · behavioral port of the ChunkFormer demo app "
        "(ICASSP 2025)</div>",
        unsafe_allow_html=True)
