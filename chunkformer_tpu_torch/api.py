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
raises. Features are computed on the device and stay there in the working
dtype; only the frame tokens come back to the host.
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
    def endless_encode_tokens(self, feats: torch.Tensor, chunk_size: int, left: int,
                              right: int, total_batch_duration: int) -> np.ndarray:
        """Stream features [T, feat] through the encoder; return frame-level CTC tokens."""
        parts = self._endless_segments(
            feats, chunk_size, left, right, total_batch_duration,
            lambda out, keep: self.model.ctc.argmax(out).reshape(-1)[:keep])
        return torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int64)

    @torch.inference_mode()
    def endless_encode(self, feats: torch.Tensor, chunk_size: int, left: int, right: int,
                       total_batch_duration: int) -> torch.Tensor:
        """Stream features [T, feat] through the encoder; return its outputs
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
    def endless_rnnt_tokens(self, feats: torch.Tensor, chunk_size: int, left: int, right: int,
                            total_batch_duration: int) -> np.ndarray:
        """Long-form RNN-T greedy: frame tokens [T', 8] (blank-padded).

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

    def _endless_segments(self, feats: torch.Tensor, chunk_size: int, left: int, right: int,
                          total_batch_duration: int, segment) -> List[torch.Tensor]:
        """The macro-segment walk of ``endless_encode`` and
        ``endless_encode_tokens``: ``segment(out [capacity, c, D], keep)``
        of every segment, in order.

        Each macro-segment's chunk rows are gathered from one zero-padded
        feature buffer on the device; the caches carry across segments, and
        each segment keeps ``trunc`` frames (all of them when it is the last).
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
        buf = feats.new_zeros((max(t_total, starts[-1] + span), feats.shape[1]),
                              dtype=self.dtype)
        buf[:t_total] = feats

        encoder = self.model.encoder
        att, cnn = encoder.init_caches(left, self.dtype, self.device)
        chunk_idx = self._meta(np.arange(capacity))
        offset = 0
        parts = []
        for start in starts:
            x_len = min(seg_raw, t_total - start)
            max_len = 1 + (x_len - chunk_ops.SUBSAMPLING_CONTEXT) // sub
            xs = chunk_ops.device_pack_segment(buf, start, c, sub, capacity)
            out, att, cnn = encoder.parallel_chunk(
                xs, chunk_idx, self._meta(np.full(capacity, offset)),
                self._meta(np.full(capacity, max_len)), c, left, right, att, cnn, trunc)
            enc_len = int(chunk_ops.calc_length(x_len))
            is_last = start + rel_right >= t_total
            keep = max(enc_len if is_last else min(trunc, enc_len), 0)
            parts.append(segment(out, keep))
            offset += keep
        return parts

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
