"""CTC loss (counterpart of ``chunkformer_tpu/ops/ctc.py:31 ctc_loss``).

The JAX function is a log-semiring scan written to match
``torch.nn.CTCLoss(reduction='none', zero_infinity=True)``; the port calls
that function. PyTorch's CTC backward returns the gradient with respect to
the logits under a log-softmax, so values agree with the JAX function and
gradients agree once taken through the log-softmax that precedes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood [B]; infeasible alignments give 0.

    log_probs [B, T, V] log-softmax outputs; targets [B, U] padded with any
    value past target_lengths.
    """
    return F.ctc_loss(log_probs.float().transpose(0, 1), targets.long(), input_lengths.long(),
                      target_lengths.long(), blank=blank, reduction="none",
                      zero_infinity=True)
