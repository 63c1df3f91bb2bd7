"""Batched CTC prefix beam search with its state on the device (counterpart
of ``chunkformer_tpu/decode/batched_beam.py``).

A fixed beam of K prefixes per utterance stays on the device of the
log-probs: a loop over frames (the JAX package's ``lax.scan``) expands the K
beams by the top P tokens and by blank or repeat, merges the blank and
non-blank scores of candidates that are the same prefix (a rolling prefix
hash, multiplier 1000003 over int32), and keeps the K best. Frames past an
utterance's length leave its beams as they are. Nothing comes to the host
until ``batched_beam_to_results``, which takes the result in one copy.

Ties: ``jax.lax.top_k`` keeps equal values in ascending index order and
``jnp.argsort`` is stable; ``torch.topk`` promises neither, so every top-k
and sort here is a stable descending sort.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

NEG_INF = -1e30
_MULT = 1000003


def _logadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    r = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG_INF / 2, torch.full_like(r, NEG_INF), r)


def top_k_by_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first, equal values in ascending index order: the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise. A stable
    descending sort keeps equal values in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits (int32 arithmetic wraps)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@torch.inference_mode()
def ctc_prefix_beam_search_batched(
    log_probs: torch.Tensor,    # [B, T, V]
    lengths: torch.Tensor,      # [B]
    beam_size: int = 10,
    token_topk: int = 16,
    max_len: int = 0,
    blank: int = 0,
):
    """Returns (tokens [B, K, U_max] int32, token_lens [B, K], scores [B, K])
    on the device of ``log_probs``, beams best first; U_max = max_len or T."""
    b, t, v = log_probs.shape
    dev = log_probs.device
    log_probs = log_probs.float()
    lengths = lengths.to(dev)
    k = beam_size
    u_max = max_len or t
    n_cand = k * (token_topk + 1)

    pb = torch.full((b, k), NEG_INF, device=dev)           # blank-ending score
    pb[:, 0] = 0.0
    pnb = torch.full((b, k), NEG_INF, device=dev)          # non-blank-ending score
    toks = torch.zeros((b, k, u_max), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    last = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    # rolling prefix hash; inactive slots get distinct hashes so they never
    # merge with the real empty prefix in slot 0
    phash = (-torch.arange(k, dtype=torch.int32, device=dev))[None, :].repeat(b, 1)
    cand_idx = torch.arange(n_cand, device=dev)[None, :]
    u_pos = torch.arange(u_max, device=dev)[None, None, :]
    blank_pad = torch.full((b, k, token_topk), NEG_INF, device=dev)

    for t_i in range(t):
        logp = log_probs[:, t_i]                            # [B, V]
        blank_lp = logp[:, blank]                           # [B]
        top_lp, top_idx = top_k_by_index(logp, token_topk)  # [B, P]
        top_idx = top_idx.to(torch.int32)

        total = _logadd(pb, pnb)                            # [B, K]

        # candidate class 0: stay on the same prefix
        #   pb' = total + blank ; pnb' = pnb + logp[last] (repeat, no blank)
        last_lp = torch.gather(logp, 1, last.clamp_min(0).long())
        last_lp = torch.where(last >= 0, last_lp, torch.full_like(last_lp, NEG_INF))
        stay_pb = total + blank_lp[:, None]
        stay_pnb = pnb + last_lp

        # candidate classes 1..P: extend the prefix with top token u
        #   repeat-after-blank comes from pb only; a new token from total
        u = top_idx[:, None, :]                             # [B, 1, P]
        u_lp = top_lp[:, None, :]
        is_repeat = u == last[:, :, None]
        ext_base = torch.where(is_repeat, pb[:, :, None], total[:, :, None])
        ext_pnb = ext_base + u_lp                           # [B, K, P]
        ext_valid = (u != blank) & (lens[:, :, None] < u_max)
        ext_pnb = torch.where(ext_valid, ext_pnb, torch.full_like(ext_pnb, NEG_INF))
        ext_hash = _wrap32(phash[:, :, None].long() * _MULT + (u.long() + 1))

        # flatten candidates: [B, C] with C = K * (P + 1)
        cand_pb = torch.cat([stay_pb[:, :, None], blank_pad], 2).reshape(b, -1)
        cand_pnb = torch.cat([stay_pnb[:, :, None], ext_pnb], 2).reshape(b, -1)
        cand_hash = torch.cat([phash[:, :, None], ext_hash], 2).reshape(b, -1)

        # merge equal-prefix candidates (componentwise blank/non-blank logadd)
        same = cand_hash[:, :, None] == cand_hash[:, None, :]     # [B, C, C]
        first = same.to(torch.int8).argmax(dim=2)                 # min index per row
        is_first = first == cand_idx

        def merge(x):
            big = torch.where(same, x[:, None, :], torch.full_like(same, NEG_INF,
                                                                   dtype=x.dtype))
            m = big.amax(dim=2)
            merged = m + torch.log(torch.exp(big - m[:, :, None]).sum(dim=2))
            merged = torch.where(m <= NEG_INF / 2, torch.full_like(merged, NEG_INF), merged)
            return torch.where(is_first, merged, torch.full_like(merged, NEG_INF))

        cand_pb = merge(cand_pb)
        cand_pnb = merge(cand_pnb)

        cand_score = _logadd(cand_pb, cand_pnb)
        _, best_flat = top_k_by_index(cand_score, k)       # [B, K]
        parent = best_flat // (token_topk + 1)
        choice = best_flat % (token_topk + 1)               # 0 = stay, j > 0 = token j-1

        new_toks = torch.gather(toks, 1, parent[:, :, None].expand(-1, -1, u_max))
        new_lens = torch.gather(lens, 1, parent)
        new_last = torch.gather(last, 1, parent)
        new_pb = torch.gather(cand_pb, 1, best_flat)
        new_pnb = torch.gather(cand_pnb, 1, best_flat)
        new_hash = torch.gather(cand_hash, 1, best_flat)

        tok_choice = torch.gather(top_idx, 1, (choice - 1).clamp_min(0))   # [B, K]
        is_ext = choice > 0
        append_pos = new_lens.clamp(0, u_max - 1)
        new_toks = torch.where((u_pos == append_pos[:, :, None]) & is_ext[:, :, None],
                               tok_choice[:, :, None], new_toks)
        new_lens = torch.where(is_ext, (new_lens + 1).clamp_max(u_max), new_lens)
        new_last = torch.where(is_ext, tok_choice, new_last)

        # frames past each utterance's length: freeze
        active = (t_i < lengths)[:, None]
        pb = torch.where(active, new_pb, pb)
        pnb = torch.where(active, new_pnb, pnb)
        toks = torch.where(active[:, :, None], new_toks, toks)
        lens = torch.where(active, new_lens, lens)
        last = torch.where(active, new_last, last)
        phash = torch.where(active, new_hash, phash)

    scores = _logadd(pb, pnb)
    order = torch.sort(-scores, dim=1, stable=True).indices
    return (torch.gather(toks, 1, order[:, :, None].expand(-1, -1, toks.shape[2])),
            torch.gather(lens, 1, order), torch.gather(scores, 1, order))


def batched_beam_to_results(tokens: torch.Tensor, token_lens: torch.Tensor,
                            scores: torch.Tensor) -> List:
    """The search's device outputs -> host ``DecodeResult``s (top-1 and
    n-best), in one copy to the host (scores as their int32 bits)."""
    from .search import DecodeResult

    b, k, u = tokens.shape
    host = torch.cat([tokens.reshape(b, k * u), token_lens.to(torch.int32),
                      scores.float().view(torch.int32)], dim=1).cpu().numpy()
    tokens = host[:, :k * u].reshape(b, k, u)
    token_lens = host[:, k * u:k * u + k]
    scores = host[:, k * u + k:].copy().view(np.float32)
    out = []
    for bi in range(b):
        nbest = [tokens[bi, ki, : token_lens[bi, ki]].tolist() for ki in range(k)]
        out.append(DecodeResult(tokens=nbest[0], score=float(scores[bi, 0]),
                                nbest=nbest, nbest_scores=scores[bi].tolist()))
    return out
