"""Training losses (counterpart of ``chunkformer_tpu/train/losses.py``):
label-smoothed cross entropy in its KL-divergence form, the hybrid CTC/AED
loss and the transducer's RNN-T + CTC + AED loss (reference:
modules/label_smoothing_loss.py, modules/asr_model.py:77-171,
transducer/transducer.py:98-208, 450-551)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import ChunkFormerConfig
from ..models.transducer import joint_forward
from ..ops.common import IGNORE_ID, add_sos_eos, reverse_pad_list, th_accuracy
from ..ops.ctc import ctc_loss
from ..ops.rnnt import (rnnt_arc_loglik, rnnt_loss, rnnt_loss_pruned, rnnt_prune_bounds,
                        rnnt_smoothed_arcs)
from ..parallel.data_group import active, count_over


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor, smoothing: float,
                         ignore_id: int = IGNORE_ID, normalize_length: bool = False,
                         group: Optional[object] = None) -> torch.Tensor:
    """KL(smoothed one-hot || softmax) summed over tokens, over the batch size
    (or the token count with normalize_length) (label_smoothing_loss.py:21-103).
    With normalize_length and a data ``group`` of P > 1 processes the
    denominator is the group's token count over P: the gradient reducers'
    mean over the P processes then gives Σ kl / Σ tokens over the global
    batch, as the JAX package's step under GSPMD."""
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
    if normalize_length and active(group):
        denom = count_over(denom, group) / dist.get_world_size(group)
    return kl.sum() / denom


def token_accuracy(logits: torch.Tensor, target: torch.Tensor,
                   group: Optional[object] = None) -> torch.Tensor:
    """``th_accuracy``; with a data ``group`` of more than one process the
    ratio of the group's correct and counted tokens, as the JAX package's
    over the global batch."""
    if not active(group):
        return th_accuracy(logits, target)
    mask = target != IGNORE_ID
    counts = count_over(torch.stack([((logits.argmax(-1) == target) & mask).sum(),
                                     mask.sum()]), group)
    return counts[0] / counts[1].clamp_min(1)


def asr_model_loss(model, cfg: ChunkFormerConfig, feats: torch.Tensor,
                   feats_lens: torch.Tensor, targets: torch.Tensor,
                   target_lens: torch.Tensor, chunk_size: int = 0,
                   left_context_size: int = 0, right_context_size: int = 0,
                   train: bool = True, generator: Optional[torch.Generator] = None,
                   step: int = 0) -> Dict[str, torch.Tensor]:
    """Hybrid CTC/AED loss: loss = w * ctc + (1 - w) * att, the attention
    loss mixing both decoder directions by reverse_weight. targets [B, U]
    padded with IGNORE_ID. Returns loss, loss_ctc, loss_att, acc_att.
    ``step`` (the optimizer step) is unused: the loss functions share one
    signature."""
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
        group = model.data_group
        loss_att = label_smoothing_loss(l_logits, ys_out, mc.lsm_weight,
                                        normalize_length=mc.length_normalized_loss,
                                        group=group)
        if r_logits is not None:
            r_loss = label_smoothing_loss(r_logits, r_ys_out, mc.lsm_weight,
                                          normalize_length=mc.length_normalized_loss,
                                          group=group)
            loss_att = (1 - mc.reverse_weight) * loss_att + mc.reverse_weight * r_loss
        metrics["loss_att"] = loss_att
        metrics["acc_att"] = token_accuracy(l_logits, ys_out, group)
        loss = loss + (1.0 - mc.ctc_weight) * loss_att

    metrics["loss"] = loss
    return metrics


def transducer_model_loss(model, cfg: ChunkFormerConfig, feats: torch.Tensor,
                          feats_lens: torch.Tensor, targets: torch.Tensor,
                          target_lens: torch.Tensor, chunk_size: int = 0,
                          left_context_size: int = 0, right_context_size: int = 0,
                          train: bool = True, generator: Optional[torch.Generator] = None,
                          step: int = 0) -> Dict[str, torch.Tensor]:
    """loss = w_t * rnnt + w_ctc * ctc + w_att * att for a ``TransducerModel``
    (transducer.py:98-208, 450-478). The RNN-T term takes one of three forms:

    - ``enable_k2`` (with the simple projections): the smoothed simple-joint
      loss plus the pruned loss on the bands its arc occupancy picks,
      mixed by the warmup schedule of the optimizer ``step``; the delay
      penalty applies from 2 * warmup_steps on (transducer.py:480-551);
    - ``use_pruned_loss`` (prejoin linears, no HAT): the pruned loss on the
      linear diagonal band;
    - else the full [B, T, U+1, V] lattice (log-softmax of the joint, or the
      HAT joint's own log-probs).

    Returns loss, loss_rnnt and, where their heads exist and weigh,
    loss_ctc and loss_att."""
    mc, jc = cfg.model_conf, cfg.joint_conf
    blank = cfg.ctc_conf.ctc_blank_id
    sos = eos = cfg.vocab_size - 1
    dev = feats.device
    enc_out, enc_mask = model.encoder.forward_train(
        feats, feats_lens, chunk_size, left_context_size, right_context_size, train, generator)
    enc_lens = enc_mask.sum(-1).to(torch.int32)

    # predictor input: the targets after a blank (transducer.py:160-170)
    tgt = targets.masked_fill(targets == IGNORE_ID, 0)
    pred_in = torch.cat([torch.full_like(tgt[:, :1], blank), tgt], 1).long()
    pred_out = model.predictor(pred_in, generator_on(generator, dev, train))
    joint = model.joint
    if mc.enable_k2 and model.simple_am_proj is not None:
        warm = float(max(mc.warmup_steps, 1))
        delay = mc.delay_penalty if step >= 2.0 * warm else 0.0
        label_lp, blank_lp = rnnt_smoothed_arcs(
            model.simple_am_proj(enc_out), model.simple_lm_proj(pred_out), tgt, enc_lens,
            target_lens, blank, mc.lm_only_scale, mc.am_only_scale, delay)
        simple_losses = -rnnt_arc_loglik(label_lp, blank_lp, enc_lens, target_lens)
        bounds = rnnt_prune_bounds(label_lp, blank_lp, enc_lens, target_lens, mc.prune_range)
        pruned_losses = rnnt_loss_pruned(
            joint.enc_ffn(enc_out), joint.pred_ffn(pred_out), tgt, enc_lens, target_lens,
            lambda x: joint.ffn_out(joint.act(x)), blank, mc.prune_range, bounds, delay)
        frac = min(step / warm, 1.0)
        losses = (1.0 - frac * 0.5) * simple_losses + (0.1 + 0.9 * frac) * pruned_losses
    elif mc.use_pruned_loss and jc.prejoin_linear and not jc.hat_joint:
        losses = rnnt_loss_pruned(
            joint.enc_ffn(enc_out), joint.pred_ffn(pred_out), tgt, enc_lens, target_lens,
            lambda x: joint.ffn_out(joint.act(x)), blank, mc.prune_range)
    else:
        logits = joint_forward(joint, enc_out, pred_out).float()
        log_probs = logits if jc.hat_joint else torch.log_softmax(logits, -1)
        losses = rnnt_loss(log_probs, tgt, enc_lens, target_lens, blank)
    loss_rnnt = losses.mean()
    metrics: Dict[str, torch.Tensor] = {"loss_rnnt": loss_rnnt}
    loss = mc.transducer_weight * loss_rnnt

    if model.ctc is not None and mc.ctc_weight > 0.0:
        logp = torch.log_softmax(model.ctc.ctc_lo(enc_out).float(), dim=-1)
        loss_ctc = ctc_loss(logp, enc_lens, tgt, target_lens, blank).sum() / feats.shape[0]
        metrics["loss_ctc"] = loss_ctc
        loss = loss + mc.ctc_weight * loss_ctc

    if model.decoder is not None and mc.attention_weight > 0.0:
        ys_in, ys_out = add_sos_eos(targets, target_lens, sos, eos)
        l_logits, _ = model.decoder(enc_out, enc_mask, ys_in, target_lens + 1, None, 0.0,
                                    generator_on(generator, dev, train))
        loss_att = label_smoothing_loss(l_logits, ys_out, mc.lsm_weight,
                                        normalize_length=mc.length_normalized_loss,
                                        group=model.data_group)
        metrics["loss_att"] = loss_att
        loss = loss + mc.attention_weight * loss_att

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
