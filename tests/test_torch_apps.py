"""The app twins on the port (``apps/realtime-asr-torch/``,
``apps/streamlit_torch/``) on the CPU.

- Every case of ``tests/test_apps.py`` on the port's modules: timestamps,
  the SRT/VTT exporters, the player's segments, the capture queue's
  drop-oldest, the file simulator (on a synthetic WAV: the JAX test's
  samples are not mounted), the microphone without a backend, and the
  streamlit twin's ``utils``, ``config``, ``audio_processing`` and
  ``ui_components``.
- ``RealtimeASR.run`` on a 3.1 s file at speed 0 (c = 6, L = 50, R = 0)
  gives the JAX app's transcript on one export: a random tiny CTC model
  (2 layers, 64 d) whose encoder biases are zeroed, as in
  ``tests/test_torch_streaming.py`` (with them one token wins every frame).
- ``transcription.transcribe_audio`` gives the JAX twin's segments on that
  export, the model loaded by ``load_model(dir, "cpu")``.
- ``app.main()`` returns 2 without streamlit (absent here and on the card).

The twin directories reuse the JAX apps' module names (``utils``,
``config``, ...), so each twin is imported with its own directory first on
``sys.path`` and its own modules in ``sys.modules`` (``_app``), and every
call into it runs there.
"""

import contextlib
import importlib
import io
import os
import string
import sys
import wave

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu_torch.data.capture import FileSimulator, _QueueCapture, open_capture
from chunkformer_tpu_torch.decode.outputs import (format_timestamp, parse_timestamp,
                                                  segments_to_srt, segments_to_vtt)

from .test_torch_api import _speechlike
from .test_torch_search import HYBRID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = os.path.join(REPO, "apps")
NAMES = ("config", "utils", "transcription", "ui_components", "audio_processing", "app",
         "stream_asr", "audio_capture")
SEGS = [{"decode": "hello world", "start": "00:00:01:000", "end": "00:00:02:500"},
        {"decode": "again", "start": "00:00:03:000", "end": "00:00:04:000"}]
STREAM = {**HYBRID, "encoder_conf": {**HYBRID["encoder_conf"], "dynamic_conv": True}}
SYMBOLS = string.ascii_lowercase + string.ascii_uppercase + string.digits + "▁"


@contextlib.contextmanager
def _app(name):
    """``apps/<name>`` first on sys.path and its own modules in
    sys.modules for the block; yields an importer of its modules."""
    saved = {n: sys.modules.pop(n) for n in NAMES if n in sys.modules}
    path = os.path.join(APPS, name)
    sys.path.insert(0, path)
    try:
        yield importlib.import_module
    finally:
        sys.path.remove(path)
        for n in NAMES:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def _zero_biases(tree):
    return {k: (_zero_biases(v) if isinstance(v, dict)
                else np.zeros_like(v) if k in ("b", "bias") else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_apps")
    rng = np.random.default_rng(12)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(12),
                                                     JaxConfig.from_dict(STREAM), cmvn))
    params["encoder"] = _zero_biases(params["encoder"])
    table = {"<blank>": 0, **{ch: i + 1 for i, ch in enumerate(SYMBOLS)}}
    model_dir = export_model_dir(str(root / "export"), STREAM, params, table)
    wav = str(root / "u.wav")
    wavfile.write(wav, 16000, _speechlike(rng, 3.1))
    return model_dir, wav


# --------------------------------------------- the cases of tests/test_apps.py


def test_timestamp_roundtrip():
    for s in (0.0, 0.08, 61.44, 3725.123):
        assert abs(parse_timestamp(format_timestamp(s)) - s) < 1e-3


def test_srt_vtt_exporters():
    srt = segments_to_srt(SEGS)
    assert "1\n00:00:01,000 --> 00:00:02,500\nhello world" in srt
    assert "2\n00:00:03,000 --> 00:00:04,000\nagain" in srt
    vtt = segments_to_vtt(SEGS)
    assert vtt.startswith("WEBVTT")
    assert "00:00:01.000 --> 00:00:02.500\nhello world" in vtt


def test_prepare_segments_for_player():
    with _app("streamlit_torch") as load:
        ui = load("ui_components")
        segs = SEGS + [{"decode": "  ", "start": "00:00:05:000", "end": "00:00:06:000"},
                       # overlapping start is clamped to the previous end
                       {"decode": "x", "start": "00:00:03:500", "end": "00:00:05:000"}]
        out = ui.prepare_segments_for_player(segs)
        assert [p["text"] for p in out] == ["hello world", "again", "x"]
        assert out[0]["start"] == 1.0 and out[0]["end"] == 2.5
        assert out[2]["start"] == 4.0  # clamped to prev end, not 3.5
        assert ui.guess_mime("a.mp4") == "video/mp4"
        assert ui.guess_mime("a.WAV") == "audio/wav"


def test_queue_capture_push_and_drop():
    cap = _QueueCapture(chunk_samples=100, max_buffer_chunks=2)
    cap._running = True
    cap._push(np.arange(250, dtype=np.float32))
    assert cap.buffered_chunks() == 2          # 2 full chunks, 50 pending
    # 150 more samples -> two more chunks -> the two oldest get dropped
    cap._push(np.arange(150, dtype=np.float32))
    assert cap.buffered_chunks() == 2
    assert cap.dropped_chunks == 2
    first = cap.read_chunk(timeout=0.1)
    expected = np.concatenate([np.arange(200, 250), np.arange(0, 50)]).astype(np.float32)
    np.testing.assert_array_equal(first, expected)


def test_file_simulator_stream(setup):
    _, wav = setup
    with open_capture(wav, chunk_samples=16000, speed=0.0) as cap:
        assert isinstance(cap, FileSimulator)
        chunks = list(cap)
    assert chunks, "no chunks produced"
    total = sum(len(c) for c in chunks)
    assert total == int(3.1 * 16000)
    assert all(len(c) == 16000 for c in chunks[:-1])
    assert cap.audio_seconds == pytest.approx(total / 16000, rel=1e-3)


def test_open_capture_mic_without_backend():
    # neither sounddevice nor pyaudio is installed in this environment
    with pytest.raises((RuntimeError, Exception)):
        cap = open_capture("mic")
        cap.start()


def test_app_utils_timestamps_and_stats():
    with _app("streamlit_torch") as load:
        u = load("utils")
        assert u.timestamp_to_seconds("00:01:02:500") == pytest.approx(62.5)
        assert u.format_timestamp(62.5) == "00:01:02:500"
        assert u.format_timestamp(u.timestamp_to_seconds("01:02:03:004")) == "01:02:03:004"
        seg = u.get_transcript_at_time(SEGS, 1.5)
        assert seg is not None and seg["decode"] == "hello world"
        assert u.get_transcript_at_time(SEGS, 2.7) is None
        assert u.transcript_stats(SEGS) == {"segments": 2, "words": 3, "speech_end": 4.0}
        assert u.plain_transcript(SEGS, with_times=False) == "hello world again"
        assert "[00:00:01:000 - 00:00:02:500]" in u.plain_transcript(SEGS)


def test_app_config_and_subtitles():
    with _app("streamlit_torch") as load:
        cfg, u = load("config"), load("utils")
        assert "wav" in cfg.APP_CONFIG.supported_formats
        assert cfg.APP_CONFIG.chunk_size == 64
        assert u.create_subtitle_srt(SEGS).startswith("1\n")
        assert u.create_subtitle_vtt(SEGS).startswith("WEBVTT")


def test_app_audio_processing_save_with_progress(tmp_path):
    with _app("streamlit_torch") as load:
        ap = load("audio_processing")

        class FakeUpload(io.BytesIO):
            name = "clip.wav"
            size = 300

        data = os.urandom(300)
        seen = []
        path, n = ap.save_uploaded_file_with_progress(FakeUpload(data),
                                                      progress_cb=seen.append)
        try:
            assert n == 300
            assert open(path, "rb").read() == data
            assert seen and seen[-1] == 1.0
            assert path.endswith(".wav")
        finally:
            os.unlink(path)
        wav = tmp_path / "t.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(b"\0\0" * 8000)
        assert ap.probe_duration_seconds(str(wav)) == pytest.approx(0.5)


def test_app_chrome_renders_without_streamlit():
    """The chrome helpers import cleanly; rendering requires streamlit (not
    installed here), so only the pure pieces are exercised."""
    with _app("streamlit_torch") as load:
        ui = load("ui_components")
        assert "cf-hero" in ui.CUSTOM_CSS
        html_doc = ui._player_html("QUJD", "audio/wav", "[]", 400)
        assert "<audio" in html_doc and "timeupdate" in html_doc


# ------------------------------------------------------ the models in the apps


def test_realtime_run_equals_the_jax_app(setup):
    from chunkformer_tpu.api import ChunkFormerModel as JaxModel
    from chunkformer_tpu_torch.api import ChunkFormerModel

    model_dir, wav = setup
    with _app("realtime-asr") as load:
        jax_asr = load("stream_asr").RealtimeASR(JaxModel.from_pretrained(model_dir), 6, 50, 0)
        want = jax_asr.run(wav, speed=0.0)
    updates = []
    with _app("realtime-asr-torch") as load:
        mod = load("stream_asr")
        assert load("audio_capture").open_capture is open_capture
        asr = mod.RealtimeASR(ChunkFormerModel.from_pretrained(model_dir, device="cpu"), 6, 50, 0)
        got = asr.run(wav, speed=0.0, on_update=lambda *a: updates.append(a))
    assert got == want and len(got) > 3
    assert len(asr.tokens) == len(jax_asr.tokens) > 0
    assert updates and updates[-1][0] == got


def test_transcribe_audio_equals_the_jax_app(setup):
    model_dir, wav = setup
    with _app("streamlit") as load:
        jt = load("transcription")
        want, _ = jt.transcribe_audio(jt.load_model(model_dir), wav, 8, 16, 16, 4)
    with _app("streamlit_torch") as load:
        tt = load("transcription")
        model = tt.load_model(model_dir, "cpu")
        assert tt.load_model(model_dir, "cpu") is model
        assert str(model.device) == "cpu"
        got, info = tt.transcribe_audio(model, wav, 8, 16, 16, 4)
    assert got == want and len(got) > 0
    assert info["segments"] == len(got) and info["elapsed_s"] > 0


def test_app_main_returns_2_without_streamlit():
    with _app("streamlit_torch") as load:
        assert load("app").main() == 2
