"""Per-sample processors: decode, fbank, augmentation, batching windows
(counterpart of ``chunkformer_tpu/data/processor.py``; reference
chunkformer/dataset/processor.py:104-619).

Host-side numpy, so data workers never touch the card. The training fbank
is the native host library's (``native/``, dither from its own generator);
``compute_fbank_numpy`` is its vectorized numpy twin with ``dither`` and
``window_type``, the plain version the tests hold it against (the card's
``ops/fbank.py`` serves decoding: povey, no dither); it shares the
package's mel bank (``ops/fbank.py:mel_banks``). Every random draw comes
from the ``rng`` passed in, in the JAX package's order, so one seed gives
the same samples in both packages.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..ops.fbank import mel_banks
from .audio import load_audio, load_wav_bytes, speed_perturb

_EPS = 1.1920928955078125e-07


def window(window_type: str, window_size: int, blackman_coeff: float = 0.42) -> np.ndarray:
    """Kaldi's analysis windows, float32."""
    n = np.arange(window_size, dtype=np.float64)
    a = 2.0 * math.pi / (window_size - 1)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif window_type == "rectangular":
        w = np.ones_like(n)
    elif window_type == "blackman":
        a = 2.0 * math.pi / window_size
        w = blackman_coeff - 0.5 * np.cos(a * n) + (0.5 - blackman_coeff) * np.cos(2 * a * n)
    else:
        raise ValueError(f"unknown window type {window_type}")
    return w.astype(np.float32)


def compute_fbank_numpy(
    waveform: np.ndarray, num_mel_bins: int = 80, frame_length: float = 25,
    frame_shift: float = 10, dither: float = 0.0, sample_rate: int = 16000,
    window_type: str = "povey", rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Vectorized Kaldi fbank (processor.py:210-239 semantics), host-side."""
    win = int(sample_rate * frame_length * 0.001)
    shift = int(sample_rate * frame_shift * 0.001)
    padded = 1 << (win - 1).bit_length()
    n = 1 + (len(waveform) - win) // shift if len(waveform) >= win else 0
    if n == 0:
        return np.zeros((0, num_mel_bins), np.float32)
    idx = np.arange(n)[:, None] * shift + np.arange(win)[None, :]
    frames = waveform[idx].astype(np.float32)
    if dither > 0 and rng is not None:
        frames = frames + dither * rng.standard_normal(frames.shape).astype(np.float32)
    frames -= frames.mean(axis=1, keepdims=True)
    prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - 0.97 * prev
    frames *= window(window_type, win)
    spec = np.abs(np.fft.rfft(frames, padded, axis=1)) ** 2
    banks = mel_banks(num_mel_bins, padded, float(sample_rate))
    return np.log(np.maximum(spec @ banks, _EPS)).astype(np.float32)


def compute_log_mel_spectrogram_numpy(
    waveform: np.ndarray, n_fft: int = 400, hop_length: int = 160,
    num_mel_bins: int = 80, sample_rate: int = 16000,
    padding: int = 0) -> np.ndarray:
    """Whisper-style log-mel spectrogram (reference processor.py:302-350):
    hann window, reflect-free centered STFT via zero padding, HTK mel scale,
    log10 with 8-dB dynamic-range clamp, (x+4)/4 normalization."""
    x = waveform.astype(np.float32) / 32768.0
    if padding > 0:
        x = np.pad(x, (0, padding))
    # centered frames (pad n_fft//2 both sides)
    x = np.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    n = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = x[idx] * np.hanning(n_fft + 1)[:-1]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    spec = spec[:-1]  # whisper drops the final frame
    # slaney-normalized mel filterbank (librosa default, as whisper uses)
    mel_f = _slaney_mel_bank(num_mel_bins, n_fft, sample_rate)
    melspec = spec @ mel_f.T
    log_spec = np.log10(np.maximum(melspec, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def _slaney_mel_bank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_step = np.log(6.4) / 27.0
        above = f >= 1000.0
        mel = np.where(above, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step, mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_step = np.log(6.4) / 27.0
        above = m >= 15.0
        return np.where(above, 1000.0 * np.exp(log_step * (m - 15.0)), f)

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def compute_mfcc_numpy(waveform: np.ndarray, num_mel_bins: int = 23,
                       num_ceps: int = 13, frame_length: float = 25,
                       frame_shift: float = 10, dither: float = 0.0,
                       sample_rate: int = 16000,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """MFCC = DCT-II of the kaldi log-mel fbank with lifter (kaldi defaults)."""
    fb = compute_fbank_numpy(waveform, num_mel_bins, frame_length, frame_shift,
                             dither, sample_rate, rng=rng)
    n = fb.shape[1]
    k = np.arange(num_ceps)[:, None]
    j = np.arange(n)[None, :]
    dct = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    dct[0] *= 1.0 / np.sqrt(2.0)
    ceps = fb @ dct.T
    lifter = 1 + 11 * np.sin(np.pi * np.arange(num_ceps) / 22.0)
    return (ceps * lifter).astype(np.float32)


# ------------------------------------------------------------------- stages


def decode_wav(sample: Dict, sample_rate: int = 16000) -> Dict:
    """{'wav': path|bytes} -> {'waveform', 'sample_rate'} (processor.py:104-158)."""
    src = sample["wav"]
    if isinstance(src, bytes):
        wav = load_wav_bytes(src, sample_rate)
    else:
        wav, _ = load_audio(src, sample_rate,
                            sample.get("start"), sample.get("end"))
    sample["waveform"] = wav
    sample["sample_rate"] = sample_rate
    return sample


def do_speed_perturb(sample: Dict, speeds=(0.9, 1.0, 1.1),
                     rng: Optional[np.random.Generator] = None) -> Dict:
    """(processor.py:183-208)"""
    rng = rng or np.random.default_rng()
    speed = speeds[rng.integers(len(speeds))]
    sample["waveform"] = speed_perturb(sample["waveform"], speed,
                                       sample["sample_rate"])
    return sample


def compute_fbank(sample: Dict, num_mel_bins: int = 80, frame_length: float = 25,
                  frame_shift: float = 10, dither: float = 0.0,
                  rng: Optional[np.random.Generator] = None) -> Dict:
    """(processor.py:210-239) The native host library's fbank
    (``native.fbank``), as the JAX package's default path: with dither its
    generator is seeded by one ``rng.integers(2**63)``, drawn only then."""
    from .. import native

    sample["feat"] = native.fbank(
        sample["waveform"], num_mel_bins, frame_length, frame_shift, dither,
        sample["sample_rate"],
        seed=int(rng.integers(2**63)) if (rng is not None and dither > 0) else 0)
    return sample


def tokenize(sample: Dict, tokenizer) -> Dict:
    """(processor.py:353-368)"""
    tokens, ids = tokenizer.tokenize(sample.get("txt", ""))
    sample["tokens"] = tokens
    sample["label"] = np.asarray(ids, np.int64)
    return sample


def filter_sample(sample: Dict, max_length: int = 40960, min_length: int = 0,
                  token_max_length: int = 400, token_min_length: int = 1,
                  min_output_input_ratio: float = 0.00005,
                  max_output_input_ratio: float = 1.0) -> bool:
    """(processor.py:370-419)"""
    n_frames = sample["feat"].shape[0]
    if not (min_length <= n_frames <= max_length):
        return False
    if "label" in sample:
        n_tok = len(sample["label"])
        if not (token_min_length <= n_tok <= token_max_length):
            return False
        if n_frames > 0:
            ratio = n_tok / n_frames
            if not (min_output_input_ratio <= ratio <= max_output_input_ratio):
                return False
    return True


def spec_aug(sample: Dict, num_t_mask: int = 2, num_f_mask: int = 2, max_t: int = 50,
             max_f: int = 10, rng: Optional[np.random.Generator] = None,
             fill: str = "zero") -> Dict:
    """SpecAugment time/freq masking (processor.py:421-456).

    Masked regions are filled with 0 like the reference (processor.py:444-452);
    fill="mean" substitutes the utterance mean."""
    rng = rng or np.random.default_rng()
    x = sample["feat"].copy()
    t, f = x.shape
    value = x.mean() if fill == "mean" else 0.0
    for _ in range(num_t_mask):
        start = rng.integers(0, max(t, 1))
        length = rng.integers(1, max_t + 1)
        x[start:start + length] = value
    for _ in range(num_f_mask):
        start = rng.integers(0, max(f, 1))
        length = rng.integers(1, max_f + 1)
        x[:, start:start + length] = value
    sample["feat"] = x
    return sample


def spec_sub(sample: Dict, max_t: int = 20, num_t_sub: int = 3,
             rng: Optional[np.random.Generator] = None) -> Dict:
    """Time substitution from earlier frames (processor.py:458-485)."""
    rng = rng or np.random.default_rng()
    x = sample["feat"].copy()
    t = x.shape[0]
    for _ in range(num_t_sub):
        if t < 2:
            break
        start = rng.integers(0, t)
        length = int(rng.integers(1, max_t + 1))
        end = min(t, start + length)
        pos = rng.integers(0, start + 1)
        x[start:end] = sample["feat"][start - pos:end - pos]
    sample["feat"] = x
    return sample


def spec_trim(sample: Dict, max_t: int = 20,
              rng: Optional[np.random.Generator] = None) -> Dict:
    """Trim trailing frames (processor.py:487-507)."""
    rng = rng or np.random.default_rng()
    t = sample["feat"].shape[0]
    length = int(rng.integers(1, max_t + 1))
    if length < t / 2:
        sample["feat"] = sample["feat"][: t - length]
    return sample


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padding(batch: List[Dict], time_bucket: int = 128, label_bucket: int = 32,
            is_classification: bool = False,
            pad_to_time: int | None = None, pad_to_label: int | None = None,
            pad_to_batch: int | None = None) -> Dict[str, np.ndarray]:
    """Collate sorted-desc by length (processor.py:509-576).

    The time and label axes are padded up to bucket multiples, so the train
    step sees a small, finite set of shapes. With pad_to_time / pad_to_label
    / pad_to_batch every batch gets one fixed shape; the batch axis is padded
    by repeating the final sample, so no zero-length utterance reaches the
    loss.
    """
    order = np.argsort([-s["feat"].shape[0] for s in batch])
    batch = [batch[i] for i in order]
    if pad_to_batch is not None and len(batch) < pad_to_batch:
        batch = batch + [batch[-1]] * (pad_to_batch - len(batch))
    feats_lens = np.array([s["feat"].shape[0] for s in batch], np.int32)
    max_t = pad_to_time or _round_up(int(feats_lens.max()), time_bucket)
    assert max_t >= int(feats_lens.max()), (max_t, int(feats_lens.max()))
    feats = np.zeros((len(batch), max_t, batch[0]["feat"].shape[1]), np.float32)
    for i, s in enumerate(batch):
        feats[i, : s["feat"].shape[0]] = s["feat"]
    out = {
        "keys": [s.get("key", str(i)) for i, s in enumerate(batch)],
        "feats": feats,
        "feats_lengths": feats_lens,
    }
    if is_classification:
        tasks = sorted(batch[0].get("class_labels", {}).keys())
        for t in tasks:
            out[f"label_{t}"] = np.array([s["class_labels"][t] for s in batch], np.int64)
    elif "label" in batch[0]:
        label_lens = np.array([len(s["label"]) for s in batch], np.int32)
        max_u = pad_to_label or _round_up(max(int(label_lens.max()), 1), label_bucket)
        assert max_u >= int(label_lens.max()), (max_u, int(label_lens.max()))
        labels = np.full((len(batch), max_u), -1, np.int64)
        for i, s in enumerate(batch):
            labels[i, : len(s["label"])] = s["label"]
        out["target"] = labels
        out["target_lengths"] = label_lens
    return out


class DynamicBatchWindow:
    """Token-budget batching predicate (processor.py:578-594):
    close the batch when longest * (n + 1) > max_frames_in_batch."""

    def __init__(self, max_frames_in_batch: int = 12000):
        self.longest = 0
        self.max_frames = max_frames_in_batch

    def __call__(self, sample: Dict, buffer_size: int) -> bool:
        n = sample["feat"].shape[0]
        self.longest = max(self.longest, n)
        if self.longest * (buffer_size + 1) > self.max_frames:
            self.longest = n
            return True
        return False
