"""Decoding strategies: CTC greedy and prefix beam, attention beam search and
attention rescoring (counterpart of ``chunkformer_tpu/decode/search.py``;
reference chunkformer/modules/search.py:33-439).

The CTC searches run on the host over numpy log-probs, copies of the JAX
package's (the prefix beam keeps its prefix dicts, its ``sorted`` keys and
its ``_log_add``, so ties fall the same way). The attention searches run
the decoder on the device of ``encoder_out`` through the fixed-size cache
step (``nn/decoder.py decoder_step``): ``attention_beam_search`` as the JAX
package's host loop (one sync a step), ``attention_beam_search_device``
with hypotheses, scores, finished flags and the cache on the device through
all ``max_len`` steps and one sync a batch.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.decoder import decoder_step, init_decoder_cache, memory_projections
from ..ops.common import IGNORE_ID, add_sos_eos, reverse_pad_list
from ..ops.masks import mask_finished_scores
from .batched_beam import top_k_by_index
from .context_graph import ContextGraph


@dataclasses.dataclass
class DecodeResult:
    """(reference: search.py:33-64)"""

    tokens: List[int]
    score: float = 0.0
    confidence: float = 0.0
    tokens_confidence: List[float] = dataclasses.field(default_factory=list)
    times: List[int] = dataclasses.field(default_factory=list)
    nbest: List[List[int]] = dataclasses.field(default_factory=list)
    nbest_scores: List[float] = dataclasses.field(default_factory=list)
    nbest_times: List[List[int]] = dataclasses.field(default_factory=list)


def ctc_greedy_search(ctc_probs: np.ndarray, lens: np.ndarray,
                      blank_id: int = 0) -> List[DecodeResult]:
    """Frame argmax + collapse (reference: search.py:113-130)."""
    results = []
    tokens = np.argmax(ctc_probs, axis=-1)
    maxp = np.max(ctc_probs, axis=-1)
    for b in range(tokens.shape[0]):
        t_len = int(lens[b])
        seq, times, confs = [], [], []
        prev = None
        for t in range(t_len):
            tok = int(tokens[b, t])
            if tok != blank_id and tok != prev:
                seq.append(tok)
                times.append(t)
                confs.append(math.exp(float(maxp[b, t])))
            prev = tok
        conf = float(np.mean(confs)) if confs else 0.0
        results.append(DecodeResult(tokens=seq, times=times, confidence=conf,
                                    tokens_confidence=confs))
    return results


def _log_add(*args: float) -> float:
    m = max(args)
    if m == -float("inf"):
        return m
    return m + math.log(sum(math.exp(a - m) for a in args))


@dataclasses.dataclass
class _PrefixScore:
    """Blank/non-blank path scores + viterbi times (reference: search.py:67-110)."""

    s: float = -float("inf")            # blank-ending score
    ns: float = -float("inf")           # non-blank-ending score
    v_s: float = -float("inf")          # viterbi blank-ending
    v_ns: float = -float("inf")         # viterbi non-blank-ending
    cur_token_prob: float = -float("inf")
    times_s: List[int] = dataclasses.field(default_factory=list)
    times_ns: List[int] = dataclasses.field(default_factory=list)
    context_state: Optional[object] = None
    context_score: float = 0.0

    def score(self):
        return _log_add(self.s, self.ns)

    def viterbi_score(self):
        return self.v_s if self.v_s > self.v_ns else self.v_ns

    def times(self):
        return self.times_s if self.v_s > self.v_ns else self.times_ns

    def total_score(self):
        return self.score() + self.context_score


def ctc_prefix_beam_search(
    ctc_probs: np.ndarray,       # [B, T, V] log-probs
    lens: np.ndarray,
    beam_size: int = 10,
    context_graph: Optional[ContextGraph] = None,
    blank_id: int = 0,
) -> List[DecodeResult]:
    """Sequential prefix beam search with n-best output
    (reference: search.py:131-249)."""
    results = []
    for b in range(ctc_probs.shape[0]):
        t_len = int(lens[b])
        cur: Dict[tuple, _PrefixScore] = {
            (): _PrefixScore(s=0.0, v_s=0.0,
                             context_state=context_graph.root if context_graph else None)
        }
        for t in range(t_len):
            logp = ctc_probs[b, t]
            # consider only top-k tokens at this frame for speed
            k = min(beam_size * 2, logp.shape[0])
            top = np.argpartition(logp, -k)[-k:]
            nxt: Dict[tuple, _PrefixScore] = defaultdict(_PrefixScore)
            for u in top:
                u = int(u)
                prob = float(logp[u])
                for prefix, ps in cur.items():
                    last = prefix[-1] if prefix else None
                    if u == blank_id:
                        n = nxt[prefix]
                        n.s = _log_add(n.s, ps.s + prob, ps.ns + prob)
                        pre_score = ps.viterbi_score()
                        if pre_score + prob > n.v_s:
                            n.v_s = pre_score + prob
                            n.times_s = ps.times().copy()
                        n.context_state = ps.context_state
                        n.context_score = ps.context_score
                    elif u == last:
                        # repeat: extend non-blank of same prefix
                        n = nxt[prefix]
                        n.ns = _log_add(n.ns, ps.ns + prob)
                        if ps.v_ns + prob > n.v_ns:
                            n.v_ns = ps.v_ns + prob
                            if n.cur_token_prob < prob:
                                n.cur_token_prob = prob
                                n.times_ns = ps.times_ns.copy()
                                if n.times_ns:
                                    n.times_ns[-1] = t
                        n.context_state = ps.context_state
                        n.context_score = ps.context_score
                        # and new token after blank
                        new_prefix = prefix + (u,)
                        n2 = nxt[new_prefix]
                        n2.ns = _log_add(n2.ns, ps.s + prob)
                        if ps.v_s + prob > n2.v_ns:
                            n2.v_ns = ps.v_s + prob
                            n2.cur_token_prob = prob
                            n2.times_ns = ps.times_s.copy() + [t]
                        if context_graph is not None and ps.context_state is not None:
                            sc, st = context_graph.forward_one_step(ps.context_state, u)
                            n2.context_score = ps.context_score + sc
                            n2.context_state = st
                    else:
                        new_prefix = prefix + (u,)
                        n = nxt[new_prefix]
                        n.ns = _log_add(n.ns, ps.s + prob, ps.ns + prob)
                        if ps.viterbi_score() + prob > n.v_ns:
                            n.v_ns = ps.viterbi_score() + prob
                            n.cur_token_prob = prob
                            n.times_ns = ps.times().copy() + [t]
                        if context_graph is not None and ps.context_state is not None:
                            sc, st = context_graph.forward_one_step(ps.context_state, u)
                            n.context_score = ps.context_score + sc
                            n.context_state = st
            cur = dict(sorted(nxt.items(), key=lambda kv: kv[1].total_score(),
                              reverse=True)[:beam_size])

        if context_graph is not None:
            for prefix, ps in cur.items():
                sc, st = context_graph.finalize(ps.context_state)
                ps.context_score += sc
                ps.context_state = st
            cur = dict(sorted(cur.items(), key=lambda kv: kv[1].total_score(),
                              reverse=True))

        nbest = [list(p) for p in cur.keys()]
        nbest_scores = [ps.total_score() for ps in cur.values()]
        nbest_times = [ps.times() for ps in cur.values()]
        best = 0
        results.append(DecodeResult(
            tokens=nbest[best] if nbest else [],
            score=nbest_scores[best] if nbest else 0.0,
            times=nbest_times[best] if nbest else [],
            nbest=nbest, nbest_scores=nbest_scores, nbest_times=nbest_times))
    return results


def _beam_setup(model, cfg, encoder_out: torch.Tensor, encoder_mask: torch.Tensor,
                beam_size: int):
    """What both attention beam searches share: the beams' memory and mask
    [B*N, T, ...], its cross-attention projections, an empty cache, and
    (sos = eos, max_len, vocab)."""
    vocab = cfg.vocab_size
    b, t, d = encoder_out.shape
    max_len = min(t, 512)
    memory = encoder_out.repeat_interleave(beam_size, dim=0)         # [B*N, T, D]
    mem_mask = encoder_mask.repeat_interleave(beam_size, dim=0)
    n_layers = len(model.decoder.left_decoder.decoders)
    cache = init_decoder_cache(n_layers, b * beam_size, max_len + 1, d, encoder_out.dtype,
                               encoder_out.device)
    return memory, mem_mask, memory_projections(model.decoder, memory), cache, vocab - 1, \
        max_len, vocab


def _best_of_beams(hyps: np.ndarray, scores: np.ndarray, b: int, n: int, eos: int,
                   length_penalty: float) -> List[DecodeResult]:
    """Each utterance's best beam by score / length penalty (the tokens up to
    the first EOS)."""
    results = []
    for bi in range(b):
        cands = []
        for ni in range(n):
            toks = []
            for tk in hyps[bi * n + ni, 1:]:
                if tk == eos:
                    break
                toks.append(int(tk))
            cands.append(toks)
        pen = np.array([((5 + len(tk)) / 6) ** length_penalty if length_penalty else 1.0
                        for tk in cands])
        final = scores[bi] / pen
        best_i = int(np.argmax(final))
        results.append(DecodeResult(tokens=cands[best_i], score=float(final[best_i])))
    return results


@torch.inference_mode()
def attention_beam_search(
    model,
    cfg,
    encoder_out: torch.Tensor,    # [B, T, D]
    encoder_mask: torch.Tensor,   # [B, T] True=valid
    beam_size: int = 10,
    length_penalty: float = 0.0,
    blank_id: int = 0,
) -> List[DecodeResult]:
    """Batched attention beam search with the top-k on the host, one sync a
    step (reference: search.py:252-355); the oracle of
    ``attention_beam_search_device``. ``model`` is an ``ASRModel`` with a
    decoder; the decoder runs on ``encoder_out``'s device."""
    b = encoder_out.shape[0]
    n = beam_size
    memory, mem_mask, memory_kv, cache, eos, max_len, vocab = _beam_setup(
        model, cfg, encoder_out, encoder_mask, n)
    sos = eos
    dev = encoder_out.device

    hyps = np.full((b * n, max_len + 1), eos, np.int32)
    hyps[:, 0] = sos
    scores = np.full((b, n), -float("inf"), np.float32)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    finished = np.zeros(b * n, bool)

    for pos in range(max_len):
        tok_in = torch.from_numpy(hyps[:, pos].astype(np.int64)).to(dev)
        logp = decoder_step(model.decoder, memory, mem_mask, tok_in, pos, cache, memory_kv)
        logp = mask_finished_scores(logp.float(), torch.from_numpy(finished).to(dev), eos)
        logp = logp.cpu().numpy()                             # [B*N, V]
        top_k_logp = logp + scores[:, None]                   # [B*N, V]
        flat = top_k_logp.reshape(b, n * vocab)
        best = np.argpartition(flat, -n, axis=1)[:, -n:]
        best_scores = np.take_along_axis(flat, best, axis=1)
        order = np.argsort(-best_scores, axis=1)
        best = np.take_along_axis(best, order, axis=1)
        scores = np.take_along_axis(best_scores, order, axis=1).reshape(-1)
        beam_idx = best // vocab                              # [B, N] parent beam
        tok = (best % vocab).astype(np.int32)

        global_parent = (beam_idx + np.arange(b)[:, None] * n).reshape(-1)
        hyps = hyps[global_parent]
        hyps[:, pos + 1] = tok.reshape(-1)
        finished = finished[global_parent] | (tok.reshape(-1) == eos)
        parent = torch.from_numpy(global_parent).to(dev)
        cache = {k: c[:, parent] for k, c in cache.items()}
        if finished.all():
            break
    return _best_of_beams(hyps, scores.reshape(b, n), b, n, eos, length_penalty)


@torch.inference_mode()
def attention_beam_search_device(
    model,
    cfg,
    encoder_out: torch.Tensor,
    encoder_mask: torch.Tensor,
    beam_size: int = 10,
    length_penalty: float = 0.0,
    blank_id: int = 0,
) -> List[DecodeResult]:
    """Attention beam search with all its state on the device of
    ``encoder_out``: one host sync a batch.

    The algorithm of ``attention_beam_search``, run as the JAX function's
    ``lax.scan``: the same fixed ``max_len`` steps (no early exit, which
    would need a sync), each a decoder step, the finished-beam mask, a top-k
    over the N x V candidates of each utterance (ties to the lower index, as
    ``jax.lax.top_k``), the parent gather of the hypotheses and the cache
    re-index. The hypotheses and scores come to the host once, at the end.
    """
    b = encoder_out.shape[0]
    n = beam_size
    memory, mem_mask, memory_kv, cache, eos, max_len, vocab = _beam_setup(
        model, cfg, encoder_out, encoder_mask, n)
    sos = eos
    dev = encoder_out.device

    hyps = torch.full((b * n, max_len + 1), eos, dtype=torch.int32, device=dev)
    hyps[:, 0] = sos
    scores = torch.full((b, n), -float("inf"), dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    finished = torch.zeros(b * n, dtype=torch.bool, device=dev)
    offsets = (torch.arange(b, device=dev) * n)[:, None]

    for pos in range(max_len):
        logp = decoder_step(model.decoder, memory, mem_mask, hyps[:, pos].long(), pos, cache,
                            memory_kv)
        logp = mask_finished_scores(logp.float(), finished, eos)
        flat = (logp + scores[:, None]).reshape(b, n * vocab)
        best_scores, best = top_k_by_index(flat, n)           # sorted desc
        tok = (best % vocab).to(torch.int32)
        parent = (best // vocab + offsets).reshape(-1)
        hyps = hyps[parent]
        hyps[:, pos + 1] = tok.reshape(-1)
        finished = finished[parent] | (tok.reshape(-1) == eos)
        cache = {k: c[:, parent] for k, c in cache.items()}
        scores = best_scores.reshape(-1)

    # the one sync: scores travel as their int32 bits beside the hypotheses
    host = torch.cat([hyps, scores.view(torch.int32)[:, None]], dim=1).cpu().numpy()
    scores_host = host[:, -1].copy().view(np.float32).reshape(b, n)
    return _best_of_beams(host[:, :-1], scores_host, b, n, eos, length_penalty)


@torch.inference_mode()
def attention_rescoring(
    model,
    cfg,
    ctc_prefix_results: List[DecodeResult],
    encoder_out: torch.Tensor,
    encoder_lens: np.ndarray,
    ctc_weight: float = 0.0,
    reverse_weight: float = 0.0,
) -> List[DecodeResult]:
    """Rescore CTC n-best with the AED decoder (reference: search.py:358-439,
    asr_model.py:398-490); the decoder runs on ``encoder_out``'s device, the
    sums of the hypotheses' log-probs on the host as in the JAX function."""
    vocab = cfg.vocab_size
    sos = eos = vocab - 1
    dev = encoder_out.device
    results = []
    for b, res in enumerate(ctc_prefix_results):
        nbest = res.nbest or [res.tokens]
        nbest_scores = res.nbest_scores or [res.score]
        n = len(nbest)
        max_u = max((len(h) for h in nbest), default=0)
        ys = np.full((n, max_u), IGNORE_ID, np.int64)
        ys_lens = np.zeros(n, np.int32)
        for i, h in enumerate(nbest):
            ys[i, :len(h)] = h
            ys_lens[i] = len(h)
        ys_t = torch.from_numpy(ys).to(dev)
        lens_t = torch.from_numpy(ys_lens).to(dev).long()
        ys_in, _ = add_sos_eos(ys_t, lens_t, sos, eos)
        r_ys = reverse_pad_list(ys_t, lens_t)
        r_ys_in, _ = add_sos_eos(r_ys, lens_t, sos, eos)

        t_len = int(encoder_lens[b])
        memory = encoder_out[b:b + 1, :t_len].expand(n, -1, -1)
        mem_mask = torch.ones((n, t_len), dtype=torch.bool, device=dev)
        l_logits, r_logits = model.decoder(memory, mem_mask, ys_in, lens_t + 1, r_ys_in,
                                           reverse_weight)
        l_logp = torch.log_softmax(l_logits.float(), -1).cpu().numpy()
        r_logp = (torch.log_softmax(r_logits.float(), -1).cpu().numpy()
                  if r_logits is not None else None)

        best_score, best_i = -float("inf"), 0
        for i, h in enumerate(nbest):
            score = sum(l_logp[i, j, tok] for j, tok in enumerate(h))
            score += l_logp[i, len(h), eos]
            if r_logp is not None and reverse_weight > 0:
                rh = list(reversed(h))
                r_score = sum(r_logp[i, j, tok] for j, tok in enumerate(rh))
                r_score += r_logp[i, len(h), eos]
                score = score * (1 - reverse_weight) + r_score * reverse_weight
            score += ctc_weight * nbest_scores[i]
            if score > best_score:
                best_score, best_i = score, i
        times = res.nbest_times[best_i] if res.nbest_times else []
        results.append(DecodeResult(tokens=nbest[best_i], score=float(best_score),
                                    times=times))
    return results
