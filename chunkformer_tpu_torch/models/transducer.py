"""RNN-T transducer: predictors, joint network, batched greedy decode
(counterpart of ``chunkformer_tpu/models/transducer.py``; reference:
transducer/{predictor.py, joint.py, transducer.py}, search/greedy_search.py).

- Predictors (label-history encoders): LSTM, multi-head positional embedding
  (arXiv 2109.07513) and depthwise conv, each with ``forward`` over a token
  sequence and ``step`` over one token and a state (JAX's
  ``predictor_forward`` and ``predictor_step`` dispatch to these).
- Joint: prejoin linears + add + activation + vocabulary projection, or the
  HAT blank/token factorization (joint.py:103-115).
- ``TransducerModel``: encoder, predictor, joint, optional CTC head, AED
  decoder and the k2 simple-joint projections, under the reference
  state-dict names, so an exported ``pytorch_model.bin`` loads with
  ``strict=True``.
- ``transducer_greedy_search``: the reference's fixed-grid greedy loop with
  the JAX function's semantics; the frame loop runs on the host and each
  frame's emit loop stops when no row emitted, at one host sync a step.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ChunkFormerConfig, JointConfig, PredictorConfig
from ..nn.decoder import BiTransformerDecoder
from ..nn.encoder import ChunkFormerEncoder
from ..nn.layers import LSTMWeights, activation, dropout
from .asr import CTC

# ----------------------------------------------------------------- predictors


class RNNPredictor(nn.Module):
    """Embedding -> LSTM layers -> projection (reference predictor.py:69-207).

    ``rnn`` holds the weights under ``torch.nn.LSTM``'s names; both the
    sequence forward and the step run them one cell at a time through
    ``torch.lstm_cell``, as the JAX cell loop does, so a step equals the
    forward at the same position. Biases are always present, as in the JAX
    parameters."""

    def __init__(self, cfg: PredictorConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        self.rnn = LSTMWeights(cfg.embed_size, cfg.hidden_size, cfg.num_layers)
        self.projection = nn.Linear(cfg.hidden_size, cfg.output_size)

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """tokens [B, U] -> [B, U, output_size] from a zero state."""
        x = dropout(self.embed(tokens), self.cfg.embed_dropout, generator)
        h0 = x.new_zeros((x.shape[0], self.cfg.hidden_size))
        for i in range(self.cfg.num_layers):
            h, c, ys = h0, h0, []
            for u in range(x.shape[1]):
                h, c = self.rnn.cell(i, x[:, u], h, c)
                ys.append(h)
            x = torch.stack(ys, 1)
        return self.projection(x)

    def step(self, tokens: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """tokens [B], state (h, c) each [layers, B, H] -> ([B, output], new state)."""
        h0, c0 = state
        x = self.embed(tokens)
        hs, cs = [], []
        for i in range(self.cfg.num_layers):
            h, c = self.rnn.cell(i, x, h0[i], c0[i])
            hs.append(h)
            cs.append(c)
            x = h
        return self.projection(x), (torch.stack(hs), torch.stack(cs))


class EmbeddingPredictor(nn.Module):
    """Multi-head positional embedding over the last ``history_size`` + 1
    tokens (arXiv 2109.07513; reference predictor.py:210-365)."""

    def __init__(self, cfg: PredictorConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.context = cfg.history_size + 1
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        self.pos_embed = nn.Linear(cfg.embed_size * self.context, cfg.n_head, bias=False)
        self.ffn = nn.Linear(cfg.embed_size, cfg.embed_size)
        self.norm = nn.LayerNorm(cfg.embed_size, eps=1e-5)
        self.act = activation(cfg.activation)

    def core(self, windows: torch.Tensor) -> torch.Tensor:
        """windows [B, S, context, E] -> [B, S, E]."""
        cfg = self.cfg
        pos = self.pos_embed.weight.view(cfg.n_head, cfg.embed_size, self.context)
        pos = pos.transpose(1, 2).to(windows.dtype)              # [n_head, context, E]
        weight = torch.einsum("bsce,hce->bshc", windows, pos)
        out = torch.einsum("bshc,bsce->bshe", weight, windows)
        out = out.sum(2) / (cfg.n_head * self.context)
        return self.act(self.norm(self.ffn(out)))

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = dropout(self.embed(tokens), self.cfg.embed_dropout, generator)
        x = F.pad(x, (0, 0, self.context - 1, 0))
        return self.core(x.unfold(1, self.context, 1).transpose(2, 3))

    def step(self, tokens: torch.Tensor, history: torch.Tensor):
        """tokens [B], history [B, context - 1, E] -> ([B, E], new history)."""
        x = self.embed.weight.to(history.dtype)[tokens][:, None]
        ctx = torch.cat([history, x], 1)
        return self.core(ctx[:, None])[:, 0], ctx[:, 1:]


class ConvPredictor(nn.Module):
    """Depthwise conv over the last ``history_size`` + 1 token embeddings
    (reference predictor.py:365-471)."""

    def __init__(self, cfg: PredictorConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.context = cfg.history_size + 1
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        self.conv = nn.Conv1d(cfg.embed_size, cfg.embed_size, self.context,
                              groups=cfg.embed_size, bias=False)
        self.norm = nn.LayerNorm(cfg.embed_size, eps=1e-5)
        self.act = activation(cfg.activation or "relu")

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S + context - 1, E] -> [B, S, E]."""
        y = F.conv1d(x.transpose(1, 2), self.conv.weight.to(x.dtype), groups=x.shape[2])
        return self.act(self.norm(y.transpose(1, 2)))

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = dropout(self.embed(tokens), self.cfg.embed_dropout, generator)
        return self._conv(F.pad(x, (0, 0, self.context - 1, 0)))

    def step(self, tokens: torch.Tensor, history: torch.Tensor):
        x = self.embed.weight.to(history.dtype)[tokens][:, None]
        ctx = torch.cat([history, x], 1)
        return self._conv(ctx)[:, 0], ctx[:, 1:]


PREDICTORS = {"rnn": RNNPredictor, "embedding": EmbeddingPredictor, "conv": ConvPredictor}


def predictor_init_state(cfg: PredictorConfig, batch: int, dtype=torch.float32, device=None):
    if cfg.predictor_type in ("embedding", "conv"):
        return torch.zeros((batch, cfg.history_size, cfg.embed_size), dtype=dtype,
                           device=device)
    shape = (cfg.num_layers, batch, cfg.hidden_size)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def predictor_state_select(cfg: PredictorConfig, emitted: torch.Tensor, new, old):
    """Per-row merge: ``new`` where ``emitted`` [B] is True."""
    if cfg.predictor_type in ("embedding", "conv"):
        return torch.where(emitted[:, None, None], new, old)
    sel = emitted[None, :, None]
    return torch.where(sel, new[0], old[0]), torch.where(sel, new[1], old[1])


# ----------------------------------------------------------------- joint network


class Joint(nn.Module):
    """(reference: transducer/joint.py:9-115). With ``hat_joint`` the blank and
    token heads are ``blank_pred.2`` and ``token_pred.2`` (the reference's
    Sequential of activation, dropout, linear; no dropout here, as in JAX)."""

    def __init__(self, cfg: JointConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.act = activation(cfg.activation)
        if cfg.prejoin_linear:
            self.enc_ffn = nn.Linear(cfg.enc_output_size, cfg.join_dim)
            self.pred_ffn = nn.Linear(cfg.pred_output_size, cfg.join_dim)
        if cfg.postjoin_linear:
            self.post_ffn = nn.Linear(cfg.join_dim, cfg.join_dim)
        if cfg.hat_joint:
            self.blank_pred = nn.Sequential(nn.Tanh(), nn.Identity(),
                                            nn.Linear(cfg.join_dim, 1))
            self.token_pred = nn.Sequential(nn.Tanh(), nn.Identity(),
                                            nn.Linear(cfg.join_dim, vocab_size - 1))
        else:
            self.ffn_out = nn.Linear(cfg.join_dim, vocab_size)


def joint_forward(joint: Joint, enc_out: torch.Tensor, pred_out: torch.Tensor
                  ) -> torch.Tensor:
    """enc [B, T, E] + pred [B, U, P] -> logits [B, T, U, V]; 4-D inputs are
    joined as they are (decode passes [B, 1, *])."""
    cfg = joint.cfg
    if cfg.prejoin_linear:
        enc_out = joint.enc_ffn(enc_out)
        pred_out = joint.pred_ffn(pred_out)
    if enc_out.dim() != 4:
        enc_out = enc_out[:, :, None, :]
    if pred_out.dim() != 4:
        pred_out = pred_out[:, None, :, :]
    out = enc_out + pred_out
    if cfg.postjoin_linear:
        out = joint.post_ffn(out)
    if not cfg.hat_joint:
        return joint.ffn_out(joint.act(out))
    blank_logp = F.logsigmoid(joint.blank_pred(out))
    scale = torch.log(torch.clamp(1.0 - torch.exp(blank_logp), min=1e-6))
    label_logp = torch.log_softmax(joint.token_pred(out), dim=-1) + scale
    return torch.cat([blank_logp, label_logp], dim=-1)


# ----------------------------------------------------------------- model assembly


class TransducerModel(nn.Module):
    """Encoder, predictor, joint; a CTC head where ``ctc`` (default:
    ctc_weight > 0), the simple-joint projections where ``simple`` (default:
    enable_k2), and the AED decoder where the config names one, as
    ``init_transducer`` (transducer.py:293-330) assembles them."""

    def __init__(self, config: ChunkFormerConfig, cmvn: bool = True,
                 ctc: Optional[bool] = None, simple: Optional[bool] = None):
        super().__init__()
        mc, vocab = config.model_conf, config.vocab_size
        pcfg = config.predictor_conf
        self.encoder = ChunkFormerEncoder(config.encoder_conf, cmvn)
        self.predictor = PREDICTORS[pcfg.predictor_type](pcfg, vocab)
        self.joint = Joint(config.joint_conf, vocab)
        d = config.encoder_conf.output_size
        self.ctc = CTC(d, vocab) if (mc.ctc_weight > 0 if ctc is None else ctc) else None
        self.simple_am_proj = self.simple_lm_proj = None
        if mc.enable_k2 if simple is None else simple:
            self.simple_am_proj = nn.Linear(d, vocab)
            self.simple_lm_proj = nn.Linear(pcfg.output_size, vocab)
        self.decoder = (BiTransformerDecoder(config.decoder_conf, vocab, d)
                        if config.decoder else None)
        self.data_group = None  # as ``ASRModel.data_group``


# ----------------------------------------------------------------- greedy search


def transducer_greedy_search(model: TransducerModel, cfg: ChunkFormerConfig,
                             encoder_out: torch.Tensor, encoder_out_lens,
                             n_steps: int = 64, blank: int = 0, init_carry=None,
                             return_carry: bool = False):
    """Batched greedy decode -> frame tokens [B, T, n_steps] on the device.

    The semantics of the JAX function (reference greedy_search.py:6-75): a
    frame emits up to ``n_steps`` symbols; the predictor's input and state
    advance only in rows that emitted a non-blank; unused slots are blank.
    A frame's emit loop stops once no row emitted (one host sync a step);
    running all ``n_steps`` masked gives the same tokens. ``init_carry`` /
    ``return_carry`` thread (last non-blank token [B], predictor state)
    across calls, so a long file decodes segment by segment as one pass.
    """
    pcfg = cfg.predictor_conf
    b, t, _ = encoder_out.shape
    dev = encoder_out.device
    lens = [int(x) for x in np.asarray(torch.as_tensor(encoder_out_lens).cpu()).reshape(-1)]
    if init_carry is not None:
        pred_input, pstate = init_carry
    else:
        pstate = predictor_init_state(pcfg, b, encoder_out.dtype, dev)
        pred_input = torch.full((b,), blank, dtype=torch.long, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    toks = torch.full((b, t, n_steps), blank, dtype=torch.long, device=dev)
    for ti in range(min(t, max(lens, default=0))):
        enc_t = encoder_out[:, ti:ti + 1]
        active = valid[:, ti]
        for step in range(n_steps):
            pred_out, pstate_new = model.predictor.step(pred_input, pstate)
            logits = joint_forward(model.joint, enc_t, pred_out[:, None, :])
            tok = torch.where(active, logits[:, 0, 0].argmax(-1), blank)
            emitted = active & (tok != blank)
            toks[:, ti, step] = tok
            pred_input = torch.where(emitted, tok, pred_input)
            pstate = predictor_state_select(pcfg, emitted, pstate_new, pstate)
            active = emitted
            if step + 1 < n_steps and not bool(active.any()):
                break
    if return_carry:
        return toks, (pred_input, pstate)
    return toks


def greedy_tokens_to_sequences(frame_tokens, encoder_out_lens, blank: int = 0
                               ) -> List[Tuple[List[int], List[int]]]:
    """Host-side: [B, T, n_steps] -> (tokens, frame times) per row."""
    frame_tokens = np.asarray(torch.as_tensor(frame_tokens).cpu())
    lens = np.asarray(torch.as_tensor(encoder_out_lens).cpu())
    results = []
    for b in range(frame_tokens.shape[0]):
        seq, times = [], []
        for t in range(int(lens[b])):
            for tok in frame_tokens[b, t]:
                if tok != blank:
                    seq.append(int(tok))
                    times.append(t)
        results.append((seq, times))
    return results
