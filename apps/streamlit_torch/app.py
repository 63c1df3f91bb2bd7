"""Streamlit long-form transcription UI on chunkformer_tpu_torch (the twin of
apps/streamlit/app.py; reference: apps/streamlit/app.py).

Upload audio/video, transcribe with endless_decode on the card (or the CPU
with --device cpu), and browse the transcript synchronized to playback
(click-to-seek, auto-scroll, search, TXT/SRT/VTT export). Run:

    streamlit run apps/streamlit_torch/app.py -- --model_checkpoint /path/to/model
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from config import APP_CONFIG  # noqa: E402


def main():
    try:
        import streamlit as st
    except ImportError:
        print("streamlit is not installed; `pip install streamlit` to run this app",
              file=sys.stderr)
        return 2

    from audio_processing import (probe_duration_seconds,
                                  save_uploaded_file_with_progress)
    from transcription import load_model, transcribe_audio
    from ui_components import (guess_mime, render_custom_css, render_footer,
                               render_hero_section, render_landing_page,
                               render_stats_row, render_synchronized_player)
    from utils import create_subtitle_srt, create_subtitle_vtt, plain_transcript

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_checkpoint", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, _ = parser.parse_known_args()

    st.set_page_config(page_title=APP_CONFIG.page_title,
                       page_icon=APP_CONFIG.page_icon, layout=APP_CONFIG.layout)
    render_custom_css()
    render_hero_section()

    with st.sidebar:
        st.subheader("Model")
        model_dir = st.text_input("Model directory",
                                  args.model_checkpoint or "")
        st.subheader("Decoding")
        preset_names = [p[0] for p in APP_CONFIG.presets] + ["Custom"]
        preset = st.selectbox("Preset", preset_names, index=0)
        if preset != "Custom":
            _, chunk_size, left_ctx, right_ctx = next(
                p for p in APP_CONFIG.presets if p[0] == preset)
            st.caption(f"chunk {chunk_size} · left {left_ctx} · right {right_ctx}")
        else:
            chunk_size = st.number_input("Chunk size",
                                         value=APP_CONFIG.chunk_size, min_value=1)
            left_ctx = st.number_input("Left context",
                                       value=APP_CONFIG.left_context_size, min_value=0)
            right_ctx = st.number_input("Right context",
                                        value=APP_CONFIG.right_context_size, min_value=0)
        budget = st.number_input("Batch duration (s)",
                                 value=APP_CONFIG.total_batch_duration, min_value=60,
                                 help="Audio seconds per device pass — the "
                                      "memory/latency knob of endless decode")
        max_silence = st.slider("Segment silence gap (s)", 0.1, 2.0,
                                APP_CONFIG.max_silence_duration)

    upload = st.file_uploader("Audio / video file",
                              type=list(APP_CONFIG.supported_formats))
    if not upload or not model_dir:
        render_landing_page()
        if upload and not model_dir:
            st.info("Set the model directory in the sidebar to transcribe.")
        render_footer()
        return 0

    # cache transcription results per (file, params) so replaying/searching
    # doesn't re-run the model
    @st.cache_resource(show_spinner=False)
    def cached_model(path):
        return load_model(path, args.device)

    @st.cache_data(show_spinner=False)
    def cached_transcribe(file_key, model_path, c, lc, rc, dur, gap,
                          media_bytes, suffix):
        import tempfile

        model = cached_model(model_path)
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
            f.write(media_bytes)
            path = f.name
        try:
            return transcribe_audio(model, path, c, lc, rc, dur, gap)
        finally:
            os.unlink(path)

    progress = st.progress(0.0, text="Reading upload...")
    path, n_bytes = save_uploaded_file_with_progress(
        upload, lambda p: progress.progress(p * 0.5, text="Reading upload..."))
    try:
        duration = probe_duration_seconds(path)
        with open(path, "rb") as f:
            media_bytes = f.read()
    finally:
        os.unlink(path)
    progress.progress(0.5, text="Transcribing...")
    file_key = f"{upload.name}:{n_bytes}"
    suffix = os.path.splitext(upload.name)[1] or ".bin"
    with st.spinner("Transcribing — long files stream in segments..."):
        segments, info = cached_transcribe(
            file_key, model_dir, int(chunk_size), int(left_ctx), int(right_ctx),
            int(budget), float(max_silence), media_bytes, suffix)
    progress.progress(1.0, text="Done")
    progress.empty()

    render_stats_row({
        "segments": info["segments"],
        "words": info["words"],
        "media": f"{duration:.0f}s" if duration else "—",
        "decode time": f"{info['elapsed_s']:.1f}s",
        "speed": f"{info['rtfx']:.1f}× RT",
    })

    render_synchronized_player(media_bytes, guess_mime(upload.name), segments,
                               height=APP_CONFIG.player_height)

    query = st.text_input("Search transcript")
    if query:
        hits = [s for s in segments
                if query.lower() in (s.get("decode") or "").lower()]
        st.caption(f"{len(hits)} matching segment(s)")
        for seg in hits:
            st.markdown(f"**{seg['start']} → {seg['end']}**  {seg['decode']}")

    col1, col2, col3, col4 = st.columns(4)
    col1.download_button("Transcript (.txt)", plain_transcript(segments),
                         file_name="transcript.txt")
    col2.download_button("Plain text (no times)",
                         plain_transcript(segments, with_times=False),
                         file_name="transcript_plain.txt")
    col3.download_button("Subtitles (.srt)", create_subtitle_srt(segments),
                         file_name="transcript.srt")
    col4.download_button("Subtitles (.vtt)", create_subtitle_vtt(segments),
                         file_name="transcript.vtt")
    render_footer()
    return 0


if __name__ == "__main__":
    main()
