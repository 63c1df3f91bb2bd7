"""Public API: ChunkFormerModel with long-form and masked-batch decoding.

Counterpart of ``chunkformer_tpu/api.py`` (reference: chunkformer_model.py:58-816):

- ``endless_decode`` — long-form single audio, streamed through the encoder
  in fixed-size macro-segments with carried attention/conv caches and exact
  relative right-context lookahead (chunkformer_model.py:320-459).
- ``batch_decode``   — masked-batch decoding of many files under a total-frame
  budget (chunkformer_model.py:461-552).
- ``encode``         — full or limited-context batch forward of padded
  features (chunkformer_model.py:256-274), with ``ctc_logprobs``;
  ``endless_encode`` — the long-form walk of ``endless_decode`` returning
  encoder outputs.
- ``classify_audio`` — per-task labels of one file from a classification
  export (chunkformer_model.py:554-646).

A transducer export (``model: transducer``) decodes with RNN-T greedy
(8 symbols a frame at most) instead of the CTC head: ``endless_decode``
carries the predictor's last token and state from macro-segment to
macro-segment (``endless_rnnt_tokens``), ``batch_decode`` un-packs the
encoder outputs per file and searches them as one padded batch
(chunkformer_model.py:437-446, 533-541).

Everything runs on ``device``, which is ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit device the constructor
raises. ``endless_decode`` computes its features on the device; the
``endless_*`` entries also take host features (a numpy array or a CPU
tensor, as ``chunkformer_tpu``'s do) and upload them segment by segment:
each segment copies only the frames not yet on the device, from pinned
host memory on a side stream, while the previous segment computes. In
bf16 the features cross as int8 with one global scale and are dequantized
on the device as ``chunkformer_tpu`` does by default (api.py:410-411,
566-583); in f32 they cross as f32. Only the frame tokens come back.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ChunkFormerConfig, EncoderConfig
from .convert import load_state_dict
from .data.audio import load_audio
from .decode.outputs import (get_output, get_output_with_timestamps, segments_from_tokens,
                             tokens_to_text)
from .models.asr import ASRModel
from .models.classification import ClassificationModel, classify_predict
from .models.transducer import (TransducerModel, greedy_tokens_to_sequences,
                                transducer_greedy_search)
from .ops import chunk as chunk_ops
from .ops.fbank import fbank


def read_symbol_table(path: str) -> Dict[str, int]:
    """vocab.txt: `symbol id` per line (reference: utils/file_utils.py:62)."""
    table = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                table[parts[0]] = int(parts[1])
            elif len(parts) == 1:
                table[parts[0]] = len(table)
    return table


def load_cmvn_file(path: str, is_json: bool = True):
    """Global CMVN stats file -> (mean, istd) float32 (reference: utils/cmvn.py:23-89).

    Either the JSON stats of tools/compute_cmvn_stats.py or the kaldi-text
    global-cmvn matrix ``[ m_1..m_D count  v_1..v_D 0 ]``.
    """
    if is_json:
        with open(path) as f:
            stats = json.load(f)
        mean_stat = np.asarray(stats["mean_stat"], dtype=np.float64)
        var_stat = np.asarray(stats["var_stat"], dtype=np.float64)
        count = stats["frame_num"]
    else:
        with open(path, "rb") as f:
            if f.read(2) == b"\0B":
                raise ValueError("binary kaldi cmvn is not supported; regenerate with "
                                 "compute-cmvn-stats --binary=false")
        with open(path, "r", encoding="utf-8") as f:
            toks = f.read().split()
        if not (toks and toks[0] == "[" and toks[-1] == "]"):
            raise ValueError(f"malformed kaldi cmvn matrix in {path}")
        vals = np.asarray([float(t) for t in toks[1:-1]], dtype=np.float64)
        if vals.size % 2 != 0:
            raise ValueError(f"kaldi cmvn stats in {path} are not 2x(D+1)")
        dim = vals.size // 2 - 1
        mean_stat, count = vals[:dim], vals[dim]
        var_stat = vals[dim + 1:2 * dim + 1]
    mean = mean_stat / count
    var = np.maximum(var_stat / count - mean * mean, 1e-20)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def quantize_int8(feats) -> Tuple[object, float]:
    """Symmetric int8 quantization with one global scale, the native host
    library's arithmetic (``ck_quantize_int8``): scale = max(max|x|, 1e-6) /
    127 in float32, q = clip(nearbyint(x * (1 / scale)), -127, 127). A numpy
    array or a CPU tensor goes through the host library and comes back as
    numpy; a tensor on a card stays there (one amax reduction, one
    elementwise pass). Both give the same q and scale, bit for bit."""
    if not isinstance(feats, torch.Tensor) or feats.device.type == "cpu":
        from . import native

        return native.quantize_int8(np.asarray(feats, dtype=np.float32))
    return quantize_int8_tensor(feats)


def quantize_int8_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """``quantize_int8`` in PyTorch on ``x``'s device (the path of features
    on a card): the scale from one amax reduction, in float32 on the host;
    one elementwise pass of float32 products rounded half to even."""
    x = x.float()
    amax = np.float32(x.abs().amax().item()) if x.numel() else np.float32(0.0)
    scale = np.maximum(amax, np.float32(1e-6)) / np.float32(127.0)
    inv = np.float32(1.0) / scale
    q = torch.round(x * float(inv)).clamp_(-127, 127).to(torch.int8)
    return q, float(scale)


def dequantize(q: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``q.astype(dtype) * scale.astype(dtype)`` (chunkformer_tpu/api.py:411)."""
    return q.to(dtype) * torch.tensor(scale, dtype=torch.float32).to(dtype).to(q.device)


def endless_sizing(cfg: EncoderConfig, chunk_size: int, right: int,
                   total_batch_duration: int):
    """Macro-segment sizing of ``endless_decode`` (chunkformer_model.py:344-371).

    Returns (trunc, rel_right, step_raw, seg_raw, capacity): subsampled frames
    kept per segment, raw frames of right-context lookahead, raw frames per
    step, raw frames per segment, and chunk rows per segment.
    """
    sub = cfg.subsampling_rate
    c = chunk_size
    max_frames = int(total_batch_duration // 0.01) // 2
    multiply_n = max(max_frames // c // sub, 1)
    trunc = c * multiply_n
    r_prime = max(right, cfg.conv_lorder)
    rel_right = (r_prime + max(c, r_prime) * (cfg.num_blocks - 1)) * sub
    step_raw = trunc * sub
    seg_raw = step_raw + 7 + rel_right
    size = (c - 1) * sub + chunk_ops.SUBSAMPLING_CONTEXT
    capacity = (max(seg_raw, size) - size) // (sub * c) + 1
    return trunc, rel_right, step_raw, seg_raw, capacity


RNNT_STEPS = 8  # symbols a frame in the transducer's greedy decode (as chunkformer_tpu)


class FeatureUpload:
    """The long-form walk's feature buffer on ``device``: [rows, feat],
    zero past the audio, in int8 (with ``scale``) or float32.

    Features already on the device are quantized (or copied) there. Host
    features (a numpy array or a CPU tensor) are quantized on the host by
    the native library, staged once in pinned memory and copied to a card
    only as the walk reaches them: ``prefetch(end)`` queues the copy of the
    frames up to ``end`` not yet queued on a side stream, ``wait(end)``
    makes the current stream wait for them and returns the buffer. So each
    frame crosses once, and the next segment's frames cross while this one
    computes (``chunkformer_tpu/api.py:536-702`` plans the same with a
    thread). ``bytes_uploaded`` counts what crossed from the host.
    """

    def __init__(self, feats, rows: int, transfer: str, device: torch.device):
        if transfer not in ("int8", "f32"):
            raise ValueError(f"transfer must be int8 or f32, got {transfer!r}")
        self.device = device
        self.scale = 1.0
        self.t_total = int(feats.shape[0])
        self.bytes_uploaded = 0
        self._queued = self._ready = 0  # frames whose copy is queued / waited for
        self._events: List[Tuple[int, object]] = []
        self._stream = None
        on_host = not isinstance(feats, torch.Tensor) or feats.device.type == "cpu"
        if transfer == "int8":
            feats, self.scale = quantize_int8(feats)
        if isinstance(feats, np.ndarray):
            feats = torch.from_numpy(np.ascontiguousarray(feats))
        if transfer == "f32":
            feats = feats.float()
        self.buf = torch.zeros((rows, feats.shape[1]), dtype=feats.dtype, device=device)
        if not on_host or device.type != "cuda":
            self.buf[:self.t_total] = feats.to(device)
            self._queued = self._ready = self.t_total
            return
        self._host = feats.contiguous().pin_memory()
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))  # the zeroed buffer
        self.buf.record_stream(self._stream)

    def prefetch(self, end: int) -> None:
        end = min(end, self.t_total)
        if self._stream is None or end <= self._queued:
            return
        with torch.cuda.stream(self._stream):
            self.buf[self._queued:end].copy_(self._host[self._queued:end], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self.bytes_uploaded += (end - self._queued) * self._host[0].nbytes
        self._queued = end
        self._events.append((end, event))

    def wait(self, end: int) -> torch.Tensor:
        self.prefetch(end)
        end = min(end, self.t_total)
        while self._ready < end:
            self._ready, event = self._events.pop(0)
            torch.cuda.current_stream(self.device).wait_event(event)
        return self.buf

    def close(self) -> None:
        """Wait for the side stream, so the pinned staging memory outlives its copies."""
        if self._stream is not None:
            self._stream.synchronize()


class ChunkFormerModel:
    """Inference-facing model wrapper around an ``ASRModel`` (or, when
    ``config.model`` is "classification" or "transducer", a
    ``ClassificationModel`` or a ``TransducerModel``) on one device."""

    def __init__(self, config: ChunkFormerConfig, state_dict: Dict[str, torch.Tensor],
                 char_dict: Optional[Dict[int, str]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.char_dict = char_dict
        self.dtype = dtype
        self.label_mapping: Optional[Dict[str, List[str]]] = None
        self.bytes_uploaded = 0  # host feature bytes the last long-form walk copied to a card
        cmvn = "encoder.global_cmvn.mean" in state_dict
        if self.is_classification:
            model = ClassificationModel(config, cmvn)
        elif self.is_transducer:
            model = TransducerModel(config, cmvn, ctc="ctc.ctc_lo.weight" in state_dict,
                                    simple="simple_am_proj.weight" in state_dict)
        else:
            model = ASRModel(config, cmvn)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval().requires_grad_(False)

    @property
    def is_transducer(self) -> bool:
        return self.config.model == "transducer"

    @property
    def is_classification(self) -> bool:
        return self.config.model == "classification"

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.float32,
                        device=None) -> "ChunkFormerModel":
        """Load a reference-format export directory: config.yaml,
        pytorch_model.bin, vocab.txt and, where the checkpoint has no CMVN
        stats, global_cmvn; a classification export also label_mapping.json.
        The encoder, CTC and, when the config names one, attention-decoder
        weights load with strict=True; a transducer also its predictor, joint
        and simple-joint projections; a classification model the encoder and
        the classification heads."""
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"model dir not found: {model_dir}")
        config = ChunkFormerConfig.from_yaml(os.path.join(model_dir, "config.yaml"))
        ckpt = next((os.path.join(model_dir, n)
                     for n in ("pytorch_model.bin", "pytorch_model.pt", "model.pt")
                     if os.path.exists(os.path.join(model_dir, n))), None)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint found in {model_dir}")
        if config.model == "classification":
            heads = ("encoder.", "classification_heads.")
        else:
            heads = ("encoder.", "ctc.") + (("decoder.",) if config.decoder else ())
            if config.model == "transducer":
                heads += ("predictor.", "joint.", "simple_am_proj.", "simple_lm_proj.")
        sd = {k: v for k, v in load_state_dict(ckpt).items() if k.startswith(heads)}
        if config.vocab_size == 0 and "ctc.ctc_lo.weight" in sd:
            config.vocab_size = sd["ctc.ctc_lo.weight"].shape[0]

        if "encoder.global_cmvn.mean" not in sd:
            for name in ("global_cmvn", "global_cmvn.json"):
                p = os.path.join(model_dir, name)
                if os.path.exists(p):
                    # the config declares the format (cmvn_conf.is_json_cmvn);
                    # otherwise sniff the first byte ("{" json, "[" kaldi text)
                    is_json = config.cmvn_conf.get("is_json_cmvn")
                    if is_json is None:
                        with open(p, "rb") as f:
                            is_json = f.read(16).lstrip().startswith(b"{")
                    mean, istd = load_cmvn_file(p, is_json=bool(is_json))
                    sd["encoder.global_cmvn.mean"] = torch.from_numpy(mean)
                    sd["encoder.global_cmvn.istd"] = torch.from_numpy(istd)
                    break

        char_dict = None
        vocab_path = os.path.join(model_dir, "vocab.txt")
        if os.path.exists(vocab_path):
            char_dict = {v: k for k, v in read_symbol_table(vocab_path).items()}
        model = cls(config, sd, char_dict, dtype, device)
        lm_path = os.path.join(model_dir, "label_mapping.json")
        if os.path.exists(lm_path):
            with open(lm_path) as f:
                model.label_mapping = json.load(f)
        return model

    # ------------------------------------------------------------------ features

    def extract_features(self, audio_path: str) -> torch.Tensor:
        """Log-mel features [T, n_mels] float32 on the model's device."""
        fbank_conf = self.config.dataset_conf.get("fbank_conf", {})
        wav, sr = load_audio(audio_path, self.config.dataset_conf.get(
            "resample_conf", {}).get("resample_rate", 16000))
        return fbank(torch.from_numpy(wav).to(self.device),
                     num_mel_bins=fbank_conf.get("num_mel_bins", 80),
                     frame_length=float(fbank_conf.get("frame_length", 25)),
                     frame_shift=float(fbank_conf.get("frame_shift", 10)),
                     sample_rate=sr)

    def _meta(self, values: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(values, dtype=np.int32)).to(self.device)

    # ------------------------------------------------------------------ decoding

    @torch.inference_mode()
    def endless_decode(
        self,
        audio_path: str,
        chunk_size: int = 64,
        left_context_size: int = 128,
        right_context_size: int = 128,
        total_batch_duration: int = 1800,
        return_timestamps: bool = True,
        max_silence_duration: float = 0.5,
    ):
        """Long-form decode with bounded memory (chunkformer_model.py:320-459).

        Returns segments with timestamps (or their joined text), or without a
        vocabulary the CTC frame tokens / the transducer's token list."""
        feats = self.extract_features(audio_path)
        if self.is_transducer:
            frame_tokens = self.endless_rnnt_tokens(feats, chunk_size, left_context_size,
                                                    right_context_size, total_batch_duration)
            (seq, times), = greedy_tokens_to_sequences(
                frame_tokens[None], [frame_tokens.shape[0]], self.config.ctc_conf.ctc_blank_id)
            if self.char_dict is None:
                return seq
            result = segments_from_tokens(seq, times, self.char_dict, max_silence_duration)
        else:
            tokens = self.endless_encode_tokens(feats, chunk_size, left_context_size,
                                                right_context_size, total_batch_duration)
            if self.char_dict is None:
                return tokens
            result = get_output_with_timestamps(tokens, self.char_dict, max_silence_duration)
        if not return_timestamps:
            return " ".join(seg["decode"] for seg in result).strip()
        return result

    @torch.inference_mode()
    def endless_encode_tokens(self, feats, chunk_size: int, left: int, right: int,
                              total_batch_duration: int) -> np.ndarray:
        """Stream features [T, feat] (on the model's device, or on the host)
        through the encoder; return frame-level CTC tokens."""
        parts = self._endless_segments(feats, chunk_size, left, right, total_batch_duration,
                                       self._ctc_tokens)
        return torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int64)

    def _ctc_tokens(self, out: torch.Tensor, keep: int) -> torch.Tensor:
        """The CTC frame tokens of a macro-segment's ``keep`` frames, on the device."""
        return self.model.ctc.argmax(out).reshape(-1)[:keep]

    @torch.inference_mode()
    def endless_encode(self, feats, chunk_size: int, left: int, right: int,
                       total_batch_duration: int) -> torch.Tensor:
        """Stream features [T, feat] (on the model's device, or on the host)
        through the encoder; return its outputs
        [T', D] as float32 on the model's device (``chunkformer_tpu`` returns
        them as a numpy float32 array)."""
        d = self.config.encoder_conf.output_size
        parts = self._endless_segments(
            feats, chunk_size, left, right, total_batch_duration,
            lambda out, keep: out.reshape(-1, d)[:keep])
        if not parts:
            return torch.zeros((0, d), dtype=torch.float32, device=self.device)
        return torch.cat(parts).float()

    @torch.inference_mode()
    def endless_rnnt_tokens(self, feats, chunk_size: int, left: int, right: int,
                            total_batch_duration: int) -> np.ndarray:
        """Long-form RNN-T greedy of features [T, feat] (on the model's
        device, or on the host): frame tokens [T', 8] (blank-padded).

        Each macro-segment's kept encoder frames are searched as it comes out
        of the encoder, with the predictor carry (last non-blank token and
        state) threaded from segment to segment, so the result equals one
        greedy pass over the whole encoder output (``chunkformer_tpu``'s
        fused scan, api.py:426-440)."""
        blank = self.config.ctc_conf.ctc_blank_id
        d = self.config.encoder_conf.output_size
        carry = None

        def segment(out, keep):
            nonlocal carry
            toks, carry = transducer_greedy_search(
                self.model, self.config, out.reshape(1, -1, d)[:, :keep], [keep],
                RNNT_STEPS, blank, init_carry=carry, return_carry=True)
            return toks[0]

        parts = self._endless_segments(feats, chunk_size, left, right, total_batch_duration,
                                       segment)
        return (torch.cat(parts).cpu().numpy() if parts
                else np.zeros((0, RNNT_STEPS), np.int64))

    def _transducer_greedy(self, enc_out: torch.Tensor, enc_lens) -> List[Tuple[List[int],
                                                                              List[int]]]:
        """Batched RNN-T greedy over padded encoder outputs [B, T, D]:
        (tokens, frame times) per row."""
        blank = self.config.ctc_conf.ctc_blank_id
        frame_tokens = transducer_greedy_search(self.model, self.config, enc_out, enc_lens,
                                                RNNT_STEPS, blank)
        return greedy_tokens_to_sequences(frame_tokens, enc_lens, blank)

    def _endless_segments(self, feats, chunk_size: int, left: int, right: int,
                          total_batch_duration: int, segment,
                          _transfer: Optional[str] = None) -> List[torch.Tensor]:
        """The macro-segment walk of ``endless_encode``, ``endless_encode_tokens``
        and ``endless_rnnt_tokens``: ``segment(out [capacity, c, D], keep)``
        of every segment, in order.

        Each macro-segment's chunk rows are gathered from one zero-padded
        feature buffer on the device; the caches carry across segments, and
        each segment keeps ``trunc`` frames (all of them when it is the last).
        ``_transfer`` ("int8" or "f32") overrides the dtype's default, int8
        in bf16 (the tests force int8 in f32).
        """
        cfg = self.config.encoder_conf
        sub = cfg.subsampling_rate
        c = chunk_size
        trunc, rel_right, step_raw, seg_raw, capacity = endless_sizing(
            cfg, c, right, total_batch_duration)
        span = (capacity - 1) * sub * c + (c - 1) * sub + chunk_ops.SUBSAMPLING_CONTEXT
        t_total = int(feats.shape[0])
        starts = []
        for start in range(0, t_total, step_raw):
            starts.append(start)
            if start + rel_right >= t_total:
                break
        if not starts:
            return []
        transfer = _transfer or ("int8" if self.dtype == torch.bfloat16 else "f32")
        upload = FeatureUpload(feats, max(t_total, starts[-1] + span), transfer, self.device)

        sizing = (trunc, rel_right, step_raw, seg_raw, capacity)
        att, cnn = self.model.encoder.init_caches(left, self.dtype, self.device)
        chunk_idx = self._meta(np.arange(capacity))
        offset = 0
        parts = []
        for i, start in enumerate(starts):
            buf = upload.wait(start + span)
            if i + 1 < len(starts):  # the next segment's new frames cross meanwhile
                upload.prefetch(starts[i + 1] + span)
            out, keep, att, cnn = self._endless_segment(
                buf, upload.scale, transfer, start, t_total, c, left, right, sizing,
                chunk_idx, offset, att, cnn)
            parts.append(segment(out, keep))
            offset += keep
        upload.close()
        self.bytes_uploaded = upload.bytes_uploaded
        return parts

    def _endless_segment(self, buf: torch.Tensor, scale: float, transfer: str, start: int,
                         t_total: int, c: int, left: int, right: int, sizing: Tuple,
                         chunk_idx: torch.Tensor, offset: int, att: torch.Tensor,
                         cnn: torch.Tensor):
        """One macro-segment of the walk on a feature buffer already on the
        device (int8 at ``scale`` or float): the chunk rows from raw frame
        ``start`` through the encoder with the carried caches. ``sizing`` is
        ``endless_sizing``'s tuple, ``t_total`` the audio's raw frames and
        ``offset`` the frames kept before this segment. Returns (out
        [capacity, c, D], keep, att, cnn); ``keep`` is ``trunc`` frames, or
        all of them when the segment is the last."""
        trunc, rel_right, _, seg_raw, capacity = sizing
        sub = self.config.encoder_conf.subsampling_rate
        x_len = min(seg_raw, t_total - start)
        max_len = 1 + (x_len - chunk_ops.SUBSAMPLING_CONTEXT) // sub
        xs = chunk_ops.device_pack_segment(buf, start, c, sub, capacity)
        xs = dequantize(xs, scale, self.dtype) if transfer == "int8" else xs.to(self.dtype)
        out, att, cnn = self.model.encoder.parallel_chunk(
            xs, chunk_idx, self._meta(np.full(capacity, offset)),
            self._meta(np.full(capacity, max_len)), c, left, right, att, cnn, trunc)
        enc_len = int(chunk_ops.calc_length(x_len))
        is_last = start + rel_right >= t_total
        keep = max(enc_len if is_last else min(trunc, enc_len), 0)
        return out, keep, att, cnn

    @torch.inference_mode()
    def batch_decode(
        self,
        audio_paths: Sequence[str],
        chunk_size: int = 64,
        left_context_size: int = 128,
        right_context_size: int = 128,
        total_batch_duration: int = 1800,
    ) -> List:
        """Masked-batch decode under a frame budget (chunkformer_model.py:461-552).

        Returns transcripts, or without a vocabulary the CTC frame-token
        arrays / the transducer's token lists."""
        max_budget = int(total_batch_duration // 0.01) // 2
        decodes: List = []
        batch_feats: List[torch.Tensor] = []
        budget = max_budget
        for i, path in enumerate(audio_paths):
            feats = self.extract_features(path)
            batch_feats.append(feats)
            budget -= feats.shape[0]
            if budget <= 0 or i == len(audio_paths) - 1:
                decodes.extend(self._decode_feature_batch(
                    batch_feats, chunk_size, left_context_size, right_context_size))
                batch_feats = []
                budget = max_budget
        return decodes

    def _decode_feature_batch(self, batch_feats: List[torch.Tensor], c: int, left: int,
                              right: int) -> List:
        encoder = self.model.encoder
        packed = chunk_ops.pack_chunks([f.to(self.dtype) for f in batch_feats],
                                       [f.shape[0] for f in batch_feats], c,
                                       self.config.encoder_conf.subsampling_rate)
        att, cnn = encoder.init_caches(left, self.dtype, self.device)
        out, _, _ = encoder.parallel_chunk(
            packed.xs, self._meta(packed.chunk_idx), self._meta(packed.offsets),
            self._meta(packed.max_lens), c, left, right, att, cnn, 0)
        if self.is_transducer:
            # un-pack per utterance, re-pad, one batched greedy search
            # (chunkformer_model.py:533-541)
            d = out.shape[-1]
            enc = out.new_zeros((len(packed.n_chunks), int(packed.out_lens.max()), d))
            for i, (rows, n) in enumerate(zip(torch.split(out, list(packed.n_chunks)),
                                              packed.out_lens)):
                enc[i, :n] = rows.reshape(-1, d)[:n]
            hyps = [seq for seq, _ in self._transducer_greedy(enc, packed.out_lens)]
            if self.char_dict is None:
                return hyps
            return [tokens_to_text(h, self.char_dict) for h in hyps]
        tokens = self.model.ctc.argmax(out).cpu().numpy()  # [N, c]
        hyps = []
        row = 0
        for n, enc_len in zip(packed.n_chunks, packed.out_lens):
            hyps.append(tokens[row:row + n].reshape(-1)[:enc_len])
            row += n
        if self.char_dict is None:
            return hyps
        return get_output(hyps, self.char_dict)

    @torch.inference_mode()
    def encode(self, xs, xs_lens, chunk_size: int = 0, left_context_size: int = 0,
               right_context_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full or limited-context batch forward (chunkformer_model.py:256-274).

        xs [B, T, feat] padded features and xs_lens [B] (tensors or numpy
        arrays, moved to the model's device). ``chunk_size`` > 0 runs
        limited-context attention over (c, L, R) through the training
        attention's forward kernel (its backward is never set up here); 0 or
        less runs full context, whatever the contexts say (the recognize
        CLI's default is -1 for all three; ``chunkformer_tpu``'s ``encode``
        builds its positional slice from L = R = -1 there and raises).
        Returns (out [B, T', D] in the model's dtype, lengths [B]) on the
        device.
        """
        if chunk_size <= 0:
            chunk_size = left_context_size = right_context_size = 0
        xs = torch.as_tensor(xs).to(device=self.device, dtype=self.dtype)
        xs_lens = torch.as_tensor(xs_lens).to(self.device)
        out, mask = self.model.encoder.forward_train(xs, xs_lens, chunk_size, left_context_size,
                                                     right_context_size, train=False)
        return out, mask.sum(-1)

    def classify_audio(self, audio_path: str, chunk_size: int = -1,
                       left_context_size: int = -1, right_context_size: int = -1):
        """Single-audio classification (chunkformer_model.py:554-646): per task
        {label, label_id, prob}. Any chunk < 0 runs full context (0, 0, 0);
        chunk_size > 0 runs the encoder at limited context (c, L, R) through
        the training attention's forward kernel."""
        if chunk_size is None or chunk_size < 0:
            chunk_size = left_context_size = right_context_size = 0
        feats = self.extract_features(audio_path)
        return classify_predict(
            self.model, feats[None].to(self.dtype),
            torch.tensor([feats.shape[0]], dtype=torch.int32, device=self.device),
            self.label_mapping, chunk_size=chunk_size, left_context_size=left_context_size,
            right_context_size=right_context_size)

    @torch.inference_mode()
    def ctc_logprobs(self, encoder_out: torch.Tensor) -> torch.Tensor:
        """log_softmax(ctc_lo(h)) in float32 (reference: modules/ctc.py:73-81)."""
        return torch.log_softmax(self.model.ctc.ctc_lo(encoder_out).float(), dim=-1)
