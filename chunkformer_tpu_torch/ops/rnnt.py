"""RNN-T losses by the log-semiring lattice recursions (counterpart of
``chunkformer_tpu/ops/rnnt.py``; the reference calls torchaudio's and k2's
losses, transducer/transducer.py:450-551).

- ``rnnt_arc_loglik``: the [T, U+1] lattice forward

      alpha[t, u] = logadd(alpha[t-1, u] + blank[t-1, u],
                           alpha[t, u-1] + label[t, u-1])

  over the T + U anti-diagonals; the lattice is skewed once into diagonal
  layout, so each diagonal is a few elementwise operations over (B, T).
- ``rnnt_loss`` (full [B, T, U+1, V] joint), ``rnnt_smoothed_arcs`` /
  ``rnnt_loss_smoothed`` (k2's smoothed simple joint), ``rnnt_prune_bounds``
  (k2's pruning ranges from the simple loss's arc occupancy),
  ``rnnt_band_bounds`` and ``rnnt_loss_pruned`` (the joint on a
  [B, T, s_range] band), ``rnnt_loss_reference`` (the plain O(T * U) loop,
  for tests).

Gradients come from autograd through the recursions. Impossible arcs hold
the finite sentinel ``NEG_INF`` and ``_logadd`` masks sums of two of them:
with -inf the gradients would be NaN. The recursions run in float32 with
autocast off.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _logadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _no_autocast(t: torch.Tensor):
    return torch.autocast(t.device.type, enabled=False)


def rnnt_arc_loglik(label_lp: torch.Tensor, blank_lp: torch.Tensor,
                    input_lengths: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """Log-likelihood [B] of the RNN-T lattice given per-arc log-probs
    label_lp and blank_lp [B, T, U+1] (label_lp[:, :, U] must be NEG_INF)."""
    b, t, u1 = blank_lp.shape
    n_diag = t + u1 - 1
    dev = blank_lp.device
    t_idx = torch.arange(t, device=dev)
    uu = torch.arange(n_diag, device=dev)[:, None] - t_idx[None, :]       # [D, T]: u = d - t
    on = (uu >= 0) & (uu < u1)
    idx = uu.clamp(0, u1 - 1).T[None].expand(b, t, n_diag)

    def skew(x):
        """[B, T, U+1] -> [B, D, T] with [b, d, t] = x[b, t, d - t] (NEG_INF off the lattice)."""
        return torch.where(on.T[None], x.gather(2, idx), NEG_INF).transpose(1, 2)

    with _no_autocast(blank_lp):
        blank_d, label_d = skew(blank_lp.float()), skew(label_lp.float())
        alpha = torch.full((b, t), NEG_INF, device=dev)
        alpha[:, 0] = 0.0
        edge_neg = alpha.new_full((b, 1), NEG_INF)
        edge_zero = alpha.new_zeros((b, 1))
        diags = [alpha]
        for d in range(1, n_diag):
            # alpha[t-1, u] and blank[t-1, u] sit at diagonal d-1, position t-1;
            # alpha[t, u-1] and label[t, u-1] at diagonal d-1, position t
            from_blank = (torch.cat([edge_neg, alpha[:, :-1]], 1)
                          + torch.cat([edge_zero, blank_d[:, d - 1, :-1]], 1))
            alpha = torch.where(on[d], _logadd(from_blank, alpha + label_d[:, d - 1]), NEG_INF)
            diags.append(alpha)
        diags = torch.stack(diags, 0)                                    # [D, B, T]
        ar = torch.arange(b, device=dev)
        t_end = input_lengths.long() - 1
        u_end = target_lengths.long()
        return diags[t_end + u_end, ar, t_end] + blank_lp.float()[ar, t_end, u_end]


def _label_mask(targets: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """Targets with positions past each length set to 0 (int64)."""
    u = targets.shape[1]
    keep = torch.arange(u, device=targets.device)[None, :] < target_lengths[:, None]
    return torch.where(keep, targets, 0).long()


def rnnt_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
              target_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-utterance RNN-T negative log-likelihood [B] of log_probs
    [B, T, U+1, V] (torchaudio.functional.rnnt_loss(reduction='none'))."""
    b, t, u1, _ = log_probs.shape
    u = u1 - 1
    assert targets.shape[1] == u, (targets.shape, u)
    tgt = _label_mask(targets, target_lengths)
    label_lp = log_probs[:, :, :u, :].gather(3, tgt[:, None, :, None].expand(b, t, u, 1))[..., 0]
    label_lp = F.pad(label_lp, (0, 1), value=NEG_INF)
    return -rnnt_arc_loglik(label_lp, log_probs[..., blank], input_lengths, target_lengths)


def rnnt_smoothed_arcs(am: torch.Tensor, lm: torch.Tensor, targets: torch.Tensor,
                       input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                       blank: int = 0, lm_only_scale: float = 0.25, am_only_scale: float = 0.0,
                       delay_penalty: float = 0.0):
    """Per-arc log-probs (label_lp, blank_lp), each [B, T, U+1], of the
    k2-style smoothed simple joint (k2.rnnt_loss_smoothed;
    transducer.py:504-517): am [B, T, V] and lm [B, U+1, V] unnormalized,
    joined additively, normalized by log(exp(am) @ exp(lm)^T) and mixed in
    probability space with the lm-only and am-only distributions

        p = (1 - l - a) * p_joint + l * p_lm + a * p_am;

    ``delay_penalty`` adds penalty * (mid_frame - t) to the label arcs."""
    with _no_autocast(am):
        am, lm = am.float(), lm.float()
        b, t, v = am.shape
        u1 = lm.shape[1]
        tgt1 = F.pad(_label_mask(targets, target_lengths), (0, 1))           # [B, U+1]

        am_max = am.amax(-1, keepdim=True).detach()
        lm_max = lm.amax(-1, keepdim=True).detach()
        z = torch.log(torch.einsum("btv,buv->btu", torch.exp(am - am_max),
                                   torch.exp(lm - lm_max)) + 1e-37)
        z = z + am_max + lm_max[:, None, :, 0]                                # [B, T, U+1]

        am_sym = am.gather(2, tgt1[:, None, :].expand(b, t, u1))              # am[b, t, tgt[u]]
        lm_sym = lm.gather(2, tgt1[..., None])[..., 0]                        # lm[b, u, tgt[u]]
        parts_label = [am_sym + lm_sym[:, None, :] - z]
        parts_blank = [am[:, :, blank][:, :, None] + lm[:, None, :, blank] - z]
        weights = [1.0 - lm_only_scale - am_only_scale]
        if lm_only_scale > 0.0:
            lm_logp = torch.log_softmax(lm, -1)
            parts_label.append(lm_logp.gather(2, tgt1[..., None])[..., 0][:, None, :]
                               .expand(b, t, u1))
            parts_blank.append(lm_logp[:, None, :, blank].expand(b, t, u1))
            weights.append(lm_only_scale)
        if am_only_scale > 0.0:
            am_logp = torch.log_softmax(am, -1)
            parts_label.append(am_logp.gather(2, tgt1[:, None, :].expand(b, t, u1)))
            parts_blank.append(am_logp[:, :, blank][:, :, None].expand(b, t, u1))
            weights.append(am_only_scale)

        logw = torch.log(torch.tensor(weights, dtype=torch.float32, device=am.device))
        label_lp = torch.logsumexp(torch.stack(parts_label, 0) + logw[:, None, None, None], 0)
        blank_lp = torch.logsumexp(torch.stack(parts_blank, 0) + logw[:, None, None, None], 0)

        mid = (input_lengths[:, None, None].float() - 1.0) / 2.0
        label_lp = label_lp + delay_penalty * (
            mid - torch.arange(t, device=am.device)[None, :, None])
        # no label transition at or after each utterance's target length
        label_lp = torch.where(torch.arange(u1, device=am.device)[None, None, :]
                               < target_lengths[:, None, None], label_lp, NEG_INF)
        return label_lp, blank_lp


def rnnt_loss_smoothed(am, lm, targets, input_lengths, target_lengths, blank: int = 0,
                       lm_only_scale: float = 0.25, am_only_scale: float = 0.0,
                       delay_penalty: float = 0.0) -> torch.Tensor:
    """Per-utterance smoothed simple-joint RNN-T loss [B] (k2.rnnt_loss_smoothed)."""
    label_lp, blank_lp = rnnt_smoothed_arcs(am, lm, targets, input_lengths, target_lengths,
                                            blank, lm_only_scale, am_only_scale, delay_penalty)
    return -rnnt_arc_loglik(label_lp, blank_lp, input_lengths, target_lengths)


def rnnt_prune_bounds(label_lp: torch.Tensor, blank_lp: torch.Tensor,
                      input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                      s_range: int) -> torch.Tensor:
    """Band starts [B, T] (int64, no gradient) from the simple joint's arcs
    (k2.get_rnnt_prune_ranges; transducer.py:518-523): each frame takes the
    s_range-slot window with the most arc occupancy, the gradient of the
    lattice log-likelihood with respect to the label arcs; a forward pass
    makes the starts non-decreasing with steps below s_range from u = 0, a
    backward pass makes the last valid frame's band hold u = target length,
    and padding frames take the last valid frame's start."""
    label_lp, blank_lp = label_lp.detach(), blank_lp.detach()
    b, t, u1 = label_lp.shape
    dev = label_lp.device
    with torch.enable_grad():
        lab = label_lp.clone().requires_grad_(True)
        occ, = torch.autograd.grad(
            rnnt_arc_loglik(lab, blank_lp, input_lengths, target_lengths).sum(), lab)

    occ = F.pad(occ, (0, max(0, s_range - u1)))
    cs = F.pad(torch.cumsum(occ, 2), (1, 0))
    win = cs[:, :, s_range:] - cs[:, :, :-s_range]                           # [B, T, starts]
    hi = (target_lengths.long()[:, None] + 1 - s_range).clamp(min=0)         # [B, 1]
    u0 = torch.minimum(win.argmax(2), hi)

    carry = torch.zeros(b, dtype=torch.long, device=dev)
    fwd = []
    for ti in range(t):
        x = carry if ti == 0 else u0[:, ti]
        carry = torch.minimum(torch.maximum(x, carry), carry + s_range - 1)
        fwd.append(carry)
    fb = torch.stack(fwd, 0)                                                 # [T, B]
    ar = torch.arange(b, device=dev)
    t_end = (input_lengths.long() - 1).clamp(0, t - 1)
    end_lo = (target_lengths.long() + 1 - s_range).clamp(min=0)
    fb[t_end, ar] = torch.maximum(fb[t_end, ar], end_lo)

    carry = fb[-1]
    bwd = [None] * t
    for ti in range(t - 1, -1, -1):
        carry = torch.maximum(fb[ti], carry - (s_range - 1))
        bwd[ti] = carry
    bounds = torch.minimum(torch.stack(bwd, 1).clamp(min=0), hi)             # [B, T]
    end_val = bounds[ar, t_end]
    return torch.where(torch.arange(t, device=dev)[None, :] < input_lengths[:, None],
                       bounds, end_val[:, None])


def rnnt_band_bounds(input_lengths: torch.Tensor, target_lengths: torch.Tensor, t: int,
                     s_range: int) -> torch.Tensor:
    """Band starts [B, T] on the linear time-label diagonal, clamped into
    [0, U - s_range + 1]."""
    t_idx = torch.arange(t, device=input_lengths.device)[None, :]
    frac = t_idx / (input_lengths[:, None] - 1).clamp(min=1)
    center = frac * target_lengths[:, None]
    u0 = torch.floor(center - s_range / 2 + 0.5).long()
    hi = (target_lengths.long()[:, None] + 1 - s_range).clamp(min=0)
    return torch.minimum(u0.clamp(min=0), hi)


def rnnt_loss_pruned(enc_proj: torch.Tensor, pred_proj: torch.Tensor, targets: torch.Tensor,
                     input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                     joint_post: Callable[[torch.Tensor], torch.Tensor], blank: int = 0,
                     s_range: int = 5, bounds: Optional[torch.Tensor] = None,
                     delay_penalty: float = 0.0) -> torch.Tensor:
    """Banded RNN-T loss [B]: the joint ``joint_post`` (x [B, T, S, J] ->
    logits) runs only on a [B, T, s_range] band of label positions starting
    at ``bounds`` [B, T] (default: the linear diagonal), so the largest
    activation is [B, T, s_range, V] instead of [B, T, U+1, V]; paths
    outside the band are excluded (transducer.py:504-542)."""
    b, t, _ = enc_proj.shape
    u = pred_proj.shape[1] - 1
    dev = enc_proj.device
    if bounds is None:
        bounds = rnnt_band_bounds(input_lengths, target_lengths, t, s_range)
    bounds = bounds.detach().long()
    s_ar = torch.arange(s_range, device=dev)
    ar = torch.arange(b, device=dev)

    band_idx = (bounds[:, :, None] + s_ar).clamp(0, u)                        # [B, T, S]
    pred_band = pred_proj[ar[:, None, None], band_idx]                       # [B, T, S, J]
    logits = joint_post(enc_proj[:, :, None, :] + pred_band)
    with _no_autocast(logits):
        log_probs = torch.log_softmax(logits.float(), -1)
        blank_lp = log_probs[..., blank]                                      # [B, T, S]
        tgt_pad = F.pad(_label_mask(targets, target_lengths), (0, 1))
        band_tgt = tgt_pad.gather(1, band_idx.reshape(b, -1)).reshape(b, t, s_range)
        label_lp = log_probs.gather(3, band_tgt[..., None])[..., 0]
        label_lp = torch.where(band_idx < target_lengths[:, None, None], label_lp, NEG_INF)
        mid = (input_lengths[:, None, None].float() - 1.0) / 2.0
        label_lp = label_lp + delay_penalty * (mid - torch.arange(t, device=dev)[None, :, None])

        def label_pass(from_blank, label_col):
            """alpha[s] = logadd(from_blank[s], alpha[s-1] + label_col[s-1])."""
            cols = [from_blank[:, 0]]
            for si in range(1, s_range):
                cols.append(_logadd(from_blank[:, si], cols[-1] + label_col[:, si - 1]))
            return torch.stack(cols, 1)

        # frame 0 starts at (t = 0, u = 0); labels chain within a frame
        alpha = label_pass(torch.where(bounds[:, :1] + s_ar == 0, 0.0, NEG_INF), label_lp[:, 0])
        # every frame's blank arrivals: slot s of frame t comes from slot
        # s + shift of frame t-1, where the band moved by shift
        src = s_ar + (bounds[:, 1:] - bounds[:, :-1])[:, :, None]             # [B, T-1, S]
        in_range = (src >= 0) & (src < s_range)
        src = src.clamp(0, s_range - 1)
        blank_src = blank_lp[:, :-1].gather(2, src)
        live = torch.arange(1, t, device=dev)[None, :] < input_lengths[:, None]
        for ti in range(1, t):
            from_blank = torch.where(in_range[:, ti - 1],
                                     alpha.gather(1, src[:, ti - 1]) + blank_src[:, ti - 1],
                                     NEG_INF)
            # frozen past each utterance's last frame
            alpha = torch.where(live[:, ti - 1, None], label_pass(from_blank, label_lp[:, ti]),
                                alpha)

        t_end = input_lengths.long() - 1
        end_slot = (target_lengths.long() - bounds[ar, t_end]).clamp(0, s_range - 1)
        return -(alpha[ar, end_slot] + blank_lp[ar, t_end, end_slot])


def rnnt_loss_reference(log_probs: torch.Tensor, targets: torch.Tensor,
                        input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                        blank: int = 0) -> torch.Tensor:
    """The plain O(T * U) loop over lattice rows (tests only)."""
    b, t, u1, _ = log_probs.shape
    u = u1 - 1
    blank_lp = log_probs[..., blank]
    tgt = _label_mask(targets, target_lengths)
    label_lp = log_probs[:, :, :u, :].gather(3, tgt[:, None, :, None].expand(b, t, u, 1))[..., 0]
    rows = []
    for ti in range(t):
        if ti == 0:
            row = torch.full((b, u1), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
            row[:, 0] = 0.0
        else:
            row = rows[-1] + blank_lp[:, ti - 1]
        cols = [row[:, 0]]
        for ui in range(1, u1):
            cols.append(_logadd(row[:, ui], cols[ui - 1] + label_lp[:, ti, ui - 1]))
        rows.append(torch.stack(cols, 1))
    alphas = torch.stack(rows, 1)
    ar = torch.arange(b, device=log_probs.device)
    t_end = input_lengths.long() - 1
    u_end = target_lengths.long()
    return -(alphas[ar, t_end, u_end] + blank_lp[ar, t_end, u_end])
