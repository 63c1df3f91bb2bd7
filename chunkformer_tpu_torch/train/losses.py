"""Training losses (counterpart of ``chunkformer_tpu/train/losses.py``):
label-smoothed cross entropy in its KL-divergence form and the hybrid
CTC/AED loss (reference: modules/label_smoothing_loss.py,
modules/asr_model.py:77-171)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..config import ChunkFormerConfig
from ..ops.common import IGNORE_ID, add_sos_eos, reverse_pad_list, th_accuracy
from ..ops.ctc import ctc_loss


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor, smoothing: float,
                         ignore_id: int = IGNORE_ID,
                         normalize_length: bool = False) -> torch.Tensor:
    """KL(smoothed one-hot || softmax) summed over tokens, over the batch size
    (or the token count with normalize_length) (label_smoothing_loss.py:21-103)."""
    b, _, v = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = target != ignore_id
    tgt = target.masked_fill(~mask, 0).long()
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    nll = -(low * logp.sum(-1)
            + (confidence - low) * torch.gather(logp, -1, tgt[..., None])[..., 0])
    # the smoothed distribution's own sum(p log p), which makes it a KL divergence
    ent = confidence * math.log(max(confidence, 1e-20)) + (v - 1) * low * math.log(
        max(low, 1e-20))
    kl = (nll + ent).masked_fill(~mask, 0.0)
    denom = mask.sum() if normalize_length else b
    return kl.sum() / denom


def asr_model_loss(model, cfg: ChunkFormerConfig, feats: torch.Tensor,
                   feats_lens: torch.Tensor, targets: torch.Tensor,
                   target_lens: torch.Tensor, chunk_size: int = 0,
                   left_context_size: int = 0, right_context_size: int = 0,
                   train: bool = True, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Hybrid CTC/AED loss: loss = w * ctc + (1 - w) * att, the attention
    loss mixing both decoder directions by reverse_weight. targets [B, U]
    padded with IGNORE_ID. Returns loss, loss_ctc, loss_att, acc_att."""
    mc = cfg.model_conf
    sos = eos = cfg.vocab_size - 1
    enc_out, enc_mask = model.encoder.forward_train(
        feats, feats_lens, chunk_size, left_context_size, right_context_size, train,
        generator)
    enc_lens = enc_mask.sum(-1).to(torch.int32)
    metrics: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=feats.device)

    if mc.ctc_weight > 0.0:
        logp = torch.log_softmax(model.ctc.ctc_lo(enc_out).float(), dim=-1)
        tgt = targets.masked_fill(targets == IGNORE_ID, 0)
        loss_ctc = ctc_loss(logp, enc_lens, tgt, target_lens,
                            cfg.ctc_conf.ctc_blank_id).sum() / feats.shape[0]
        metrics["loss_ctc"] = loss_ctc
        loss = loss + mc.ctc_weight * loss_ctc

    if model.decoder is not None and mc.ctc_weight < 1.0:
        ys_in, ys_out = add_sos_eos(targets, target_lens, sos, eos)
        r_ys_in, r_ys_out = add_sos_eos(reverse_pad_list(targets, target_lens), target_lens,
                                        sos, eos)
        l_logits, r_logits = model.decoder(enc_out, enc_mask, ys_in, target_lens + 1, r_ys_in,
                                           mc.reverse_weight,
                                           generator_on(generator, feats.device, train))
        loss_att = label_smoothing_loss(l_logits, ys_out, mc.lsm_weight,
                                        normalize_length=mc.length_normalized_loss)
        if r_logits is not None:
            r_loss = label_smoothing_loss(r_logits, r_ys_out, mc.lsm_weight,
                                          normalize_length=mc.length_normalized_loss)
            loss_att = (1 - mc.reverse_weight) * loss_att + mc.reverse_weight * r_loss
        metrics["loss_att"] = loss_att
        metrics["acc_att"] = th_accuracy(l_logits, ys_out)
        loss = loss + (1.0 - mc.ctc_weight) * loss_att

    metrics["loss"] = loss
    return metrics


def generator_on(generator: Optional[torch.Generator], device: torch.device,
                 train: bool = True) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded from a draw of ``generator`` (None
    when there is no generator or no training)."""
    if generator is None or not train:
        return None
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)
