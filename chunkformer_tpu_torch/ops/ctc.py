"""CTC loss, greedy tokens and forced alignment (counterpart of
``chunkformer_tpu/ops/ctc.py``: ``ctc_loss`` :31, ``ctc_greedy`` :93,
``remove_duplicates_and_blank`` :98, ``ctc_forced_align`` :111).

The JAX function is a log-semiring scan written to match
``torch.nn.CTCLoss(reduction='none', zero_infinity=True)``; the port calls
that function. PyTorch's CTC backward returns the gradient with respect to
the logits under a log-softmax, so values agree with the JAX function and
gradients agree once taken through the log-softmax that precedes it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood [B]; infeasible alignments give 0.

    log_probs [B, T, V] log-softmax outputs; targets [B, U] padded with any
    value past target_lengths.
    """
    return F.ctc_loss(log_probs.float().transpose(0, 1), targets.long(), input_lengths.long(),
                      target_lengths.long(), blank=blank, reduction="none",
                      zero_infinity=True)


def ctc_greedy(log_probs: torch.Tensor) -> torch.Tensor:
    """Frame-level argmax tokens [B, T]."""
    return log_probs.argmax(dim=-1)


def remove_duplicates_and_blank(tokens: Sequence[int], blank: int = 0) -> List[int]:
    """Host-side CTC collapse (reference: utils/model_utils.py:23-45)."""
    out = []
    prev = None
    for tok in tokens:
        tok = int(tok)
        if tok != blank and tok != prev:
            out.append(tok)
        prev = tok
    return out


def ctc_forced_align(log_probs: torch.Tensor, targets: Sequence[int], input_length: int,
                     blank: int = 0) -> np.ndarray:
    """Viterbi CTC alignment: the state label of every frame [T] (token ids,
    blank included), as the JAX function computes it.

    log_probs [T, V] on any device. The recurrence runs over the frames with
    its state on that device: over the blank-interleaved labels ext [S = 2U +
    1], each state keeps the best of staying, stepping from the previous
    state and (at a label that differs from the one two back) skipping a
    blank, ties to the earliest of those three; frames at or past
    ``input_length`` carry the state unchanged. The backpointers come to the
    host once, and the path is traced back there, from the final blank or
    the last label, whichever scores higher (the final blank on a tie).
    Frames past ``input_length`` take the final state's label.
    """
    t = log_probs.shape[0]
    dev = log_probs.device
    u = len(targets)
    s = 2 * u + 1
    ext = torch.full((s,), blank, dtype=torch.long)
    ext[1::2] = torch.as_tensor(list(targets), dtype=torch.long)
    ext_dev = ext.to(dev)
    emit = log_probs[:, ext_dev]                                    # [T, S]
    idx = torch.arange(s, device=dev)
    can_skip = (idx % 2 == 1) & (idx >= 2) & (ext_dev != torch.roll(ext_dev, 2))
    alpha = torch.full((s,), NEG_INF, dtype=emit.dtype, device=dev)
    alpha[0] = emit[0, 0]
    if s > 1:
        alpha[1] = emit[0, 1]
    neg = torch.full((2,), NEG_INF, dtype=emit.dtype, device=dev)
    backs = torch.zeros((max(t - 1, 0), s), dtype=torch.uint8, device=dev)
    for ti in range(1, min(t, input_length)):
        diag = torch.cat([neg[:1], alpha[:-1]])
        skip = torch.where(can_skip, torch.cat([neg, alpha[:-2]])[:s], neg[0])
        best = torch.maximum(torch.maximum(alpha, diag), skip)
        backs[ti - 1] = torch.where(best == alpha, 0, torch.where(best == diag, 1, 2))
        alpha = best + emit[ti]
    alpha, backs = alpha.cpu().numpy(), backs.cpu().numpy()
    last = 2 * u
    prev = max(last - 1, 0)
    state = last if alpha[last] >= alpha[prev] else prev
    final = state
    states = np.empty(t, np.int64)
    for ti in range(t - 1, 0, -1):
        states[ti] = state
        state -= int(backs[ti - 1, state])
    if t:
        states[0] = state
    states[np.arange(t) >= input_length] = final
    return ext.numpy()[states]
