"""Audio capture backends for realtime streaming ASR (a copy of
``chunkformer_tpu/data/capture.py`` that loads audio through this package).

Capture layer for `chunkformer_tpu_torch.bin.stream` (behavioral counterpart
of the reference capture module, apps/realtime-asr/audio_capture.py: device
enumeration + callback capture + bounded buffering + a file simulator), built
around one small interface:

    with open_capture(source, sample_rate=16000, chunk_samples=7680) as cap:
        while (chunk := cap.read_chunk(timeout=1.0)) is not None:
            ...  # float32 PCM at int16 scale, mono

- ``SoundDeviceCapture`` / ``PyAudioCapture``: microphone capture via a
  backend callback thread pushing into a bounded queue; overflow drops the
  oldest chunk (live ASR wants the newest audio, not backpressure).
- ``FileSimulator``: replays a wav file at realtime (or ``speed``x) pace —
  the testable path used by CI and `--audio_file`.
- ``open_capture``: "mic" -> first available backend; a path -> simulator.

All backends are import-gated: neither sounddevice nor pyaudio is required
unless actually used.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np


class CaptureBase:
    """start/stop/read_chunk/iterator/context-manager protocol."""

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def read_chunk(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        """Next float32 mono chunk at int16 scale, or None on end/timeout."""
        raise NotImplementedError

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            chunk = self.read_chunk()
            if chunk is None:
                return
            yield chunk


class _QueueCapture(CaptureBase):
    """Shared bounded-queue plumbing for callback-driven backends."""

    def __init__(self, chunk_samples: int, max_buffer_chunks: int = 64):
        self.chunk_samples = chunk_samples
        self._q: queue.Queue = queue.Queue(maxsize=max_buffer_chunks)
        self._pending = np.zeros(0, np.float32)
        self._running = False
        self.dropped_chunks = 0

    def _push(self, samples: np.ndarray) -> None:
        """Accumulate backend buffers into fixed-size chunks; drop oldest on
        overflow so the queue always holds the freshest audio."""
        self._pending = np.concatenate([self._pending, samples])
        while self._pending.shape[0] >= self.chunk_samples:
            chunk = self._pending[: self.chunk_samples]
            self._pending = self._pending[self.chunk_samples:]
            try:
                self._q.put_nowait(chunk)
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped_chunks += 1
                except queue.Empty:
                    pass
                self._q.put_nowait(chunk)

    def read_chunk(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        if not self._running and self._q.empty():
            return None
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def buffered_chunks(self) -> int:
        return self._q.qsize()


def list_input_devices() -> List[Tuple[int, str]]:
    """(index, name) of input-capable devices, empty if no backend/devices."""
    try:
        import sounddevice as sd

        return [(i, d["name"]) for i, d in enumerate(sd.query_devices())
                if d.get("max_input_channels", 0) > 0]
    except Exception:  # noqa: BLE001 — no backend / no audio subsystem
        pass
    try:
        import pyaudio

        pa = pyaudio.PyAudio()
        out = []
        for i in range(pa.get_device_count()):
            d = pa.get_device_info_by_index(i)
            if d.get("maxInputChannels", 0) > 0:
                out.append((i, d.get("name", f"device {i}")))
        pa.terminate()
        return out
    except Exception:  # noqa: BLE001
        return []


class SoundDeviceCapture(_QueueCapture):
    """Microphone capture via the sounddevice (PortAudio) callback API."""

    def __init__(self, sample_rate: int = 16000, chunk_samples: int = 7680,
                 device: Optional[int] = None, max_buffer_chunks: int = 64):
        super().__init__(chunk_samples, max_buffer_chunks)
        self.sample_rate = sample_rate
        self.device = device
        self._stream = None

    def start(self) -> None:
        import sounddevice as sd

        def callback(indata, frames, time_info, status):
            # int16 scale matches the fbank front-end (waveform * 2^15)
            self._push(indata[:, 0].astype(np.float32) * 32768.0
                       if indata.dtype.kind == "f"
                       else indata[:, 0].astype(np.float32))

        self._stream = sd.InputStream(
            samplerate=self.sample_rate, channels=1, dtype="float32",
            device=self.device, callback=callback,
            blocksize=self.chunk_samples // 4 or self.chunk_samples)
        self._stream.start()
        self._running = True

    def stop(self) -> None:
        self._running = False
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


class PyAudioCapture(_QueueCapture):
    """Microphone capture via the PyAudio callback API (fallback backend)."""

    def __init__(self, sample_rate: int = 16000, chunk_samples: int = 7680,
                 device: Optional[int] = None, max_buffer_chunks: int = 64):
        super().__init__(chunk_samples, max_buffer_chunks)
        self.sample_rate = sample_rate
        self.device = device
        self._pa = None
        self._stream = None

    def start(self) -> None:
        import pyaudio

        self._pa = pyaudio.PyAudio()

        def callback(in_data, frame_count, time_info, status):
            self._push(np.frombuffer(in_data, np.int16).astype(np.float32))
            return (None, pyaudio.paContinue)

        self._stream = self._pa.open(
            format=pyaudio.paInt16, channels=1, rate=self.sample_rate,
            input=True, input_device_index=self.device,
            frames_per_buffer=self.chunk_samples // 4 or self.chunk_samples,
            stream_callback=callback)
        self._stream.start_stream()
        self._running = True

    def stop(self) -> None:
        self._running = False
        if self._stream is not None:
            self._stream.stop_stream()
            self._stream.close()
            self._stream = None
        if self._pa is not None:
            self._pa.terminate()
            self._pa = None


class FileSimulator(CaptureBase):
    """Replay a wav file as a realtime stream (speed=0 -> as fast as possible).

    A producer thread paces chunks at chunk_duration/speed, so the consumer
    sees the same timing behavior as a microphone — the CI-friendly way to
    test the full streaming loop.
    """

    def __init__(self, path: str, sample_rate: int = 16000,
                 chunk_samples: int = 7680, speed: float = 0.0):
        self.path = path
        self.sample_rate = sample_rate
        self.chunk_samples = chunk_samples
        self.speed = speed
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.audio_seconds = 0.0

    def start(self) -> None:
        from .audio import load_audio

        wav, sr = load_audio(self.path)
        if sr != self.sample_rate:
            # simple linear resample; capture is host-side utility code
            n = int(round(len(wav) * self.sample_rate / sr))
            wav = np.interp(np.linspace(0, len(wav) - 1, n),
                            np.arange(len(wav)), wav).astype(np.float32)
        self.audio_seconds = len(wav) / self.sample_rate
        pace = (self.chunk_samples / self.sample_rate / self.speed
                if self.speed > 0 else 0.0)

        def producer():
            for i in range(0, len(wav), self.chunk_samples):
                if self._stop.is_set():
                    break
                t0 = time.perf_counter()
                self._q.put(wav[i: i + self.chunk_samples].astype(np.float32))
                if pace:
                    time.sleep(max(0.0, pace - (time.perf_counter() - t0)))
            self._q.put(None)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def read_chunk(self, timeout: float = 10.0) -> Optional[np.ndarray]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


# reference class name (apps/realtime-asr/audio_capture.py:524)
AudioFileSimulator = FileSimulator


def open_capture(source: str, sample_rate: int = 16000,
                 chunk_samples: int = 7680, device: Optional[int] = None,
                 speed: float = 0.0) -> CaptureBase:
    """"mic" -> first available microphone backend; a path -> FileSimulator."""
    if source != "mic":
        return FileSimulator(source, sample_rate, chunk_samples, speed)
    # sounddevice raises OSError (not ImportError) at import time when the
    # PortAudio shared library is missing — fall through to pyaudio on any
    # probe failure, matching list_input_devices.
    try:
        import sounddevice  # noqa: F401

        return SoundDeviceCapture(sample_rate, chunk_samples, device)
    except Exception:
        pass
    try:
        import pyaudio  # noqa: F401

        return PyAudioCapture(sample_rate, chunk_samples, device)
    except Exception:
        raise RuntimeError(
            "microphone capture needs sounddevice or pyaudio; "
            "use --audio_file to simulate from a wav") from None
