"""RNN-T beam searches beyond greedy (counterpart of
``chunkformer_tpu/models/transducer_search.py``; reference:
transducer/search/prefix_beam_search.py:8-146).

Breadth-first over frames, one emission at most per frame and hypothesis,
prefix merging, optional CTC shallow fusion. Each frame runs all beams'
predictor and joint steps as one batch on the encoder output's device, with
the predictor states kept there; the ragged beam bookkeeping stays on the
host (one copy of the frame's log-probs a frame).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ChunkFormerConfig
from .transducer import joint_forward, predictor_init_state


@dataclasses.dataclass
class Sequence:
    """(reference prefix_beam_search.py:8-20)"""

    hyp: List[int]
    score: float
    state: Tuple  # predictor state of this hypothesis, batch 1, on the device
    ctc_state: Optional[Tuple[float, float]] = None


def _log_add(a: float, b: float) -> float:
    if a == -float("inf"):
        return b
    if b == -float("inf"):
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _stack_states(pcfg, states):
    """Batch-1 predictor states -> one batched state."""
    if pcfg.predictor_type in ("embedding", "conv"):
        return torch.cat(states, 0)
    return torch.cat([s[0] for s in states], 1), torch.cat([s[1] for s in states], 1)


def _index_state(pcfg, state, i: int):
    """Batched predictor state -> the batch-1 state of beam i."""
    if pcfg.predictor_type in ("embedding", "conv"):
        return state[i:i + 1]
    return state[0][:, i:i + 1], state[1][:, i:i + 1]


@torch.inference_mode()
def transducer_prefix_beam_search(
    model,
    cfg: ChunkFormerConfig,
    encoder_out: torch.Tensor,                     # [T, E], one utterance, on the device
    beam_size: int = 10,
    ctc_log_probs: Optional[np.ndarray] = None,    # [T, V] for shallow fusion
    ctc_weight: float = 0.3,
    transducer_weight: float = 0.7,
    blank: int = 0,
) -> List[Sequence]:
    """Beam search over the transducer lattice (prefix_beam_search.py:41-146).
    Returns the beams sorted by descending length-normalized score."""
    pcfg = cfg.predictor_conf
    dev = encoder_out.device
    fuse = ctc_log_probs is not None
    beams = [Sequence(hyp=[blank], score=0.0,
                      state=predictor_init_state(pcfg, 1, encoder_out.dtype, dev),
                      ctc_state=(0.0, -float("inf")) if fuse else None)]

    for t in range(encoder_out.shape[0]):
        tokens = torch.tensor([b.hyp[-1] for b in beams], dtype=torch.long, device=dev)
        pred_out, new_state = model.predictor.step(tokens,
                                                   _stack_states(pcfg, [b.state for b in beams]))
        logits = joint_forward(model.joint, encoder_out[t][None, None, :], pred_out[:, None, :])
        logp = torch.log_softmax(logits[:, 0, 0, :].float(), -1).cpu().numpy()

        # expand: blank keeps the hypothesis and its state; a token extends it
        cand: dict = {}
        for bi, b in enumerate(beams):
            key = tuple(b.hyp)
            sc = b.score + float(logp[bi, blank])
            if key in cand:
                cand[key].score = _log_add(cand[key].score, sc)
            else:
                cand[key] = Sequence(hyp=b.hyp, score=sc, state=b.state, ctc_state=b.ctc_state)
            k = min(beam_size, logp.shape[1])
            for u in np.argpartition(logp[bi], -k)[-k:]:
                u = int(u)
                if u == blank:
                    continue
                sc_u = b.score + transducer_weight * float(logp[bi, u])
                if fuse:
                    sc_u += ctc_weight * float(ctc_log_probs[t, u])
                key_u = key + (u,)
                if key_u in cand:
                    cand[key_u].score = _log_add(cand[key_u].score, sc_u)
                else:
                    cand[key_u] = Sequence(hyp=list(key_u), score=sc_u,
                                           state=_index_state(pcfg, new_state, bi),
                                           ctc_state=b.ctc_state)
        beams = sorted(cand.values(), key=lambda s: s.score, reverse=True)[:beam_size]

    beams.sort(key=lambda s: s.score / max(len(s.hyp) - 1, 1), reverse=True)
    return beams


def transducer_attention_rescoring(model, cfg: ChunkFormerConfig, beams: List[Sequence],
                                   encoder_out: torch.Tensor, reverse_weight: float = 0.0
                                   ) -> List[int]:
    """Rescore the transducer n-best with the AED decoder
    (reference: transducer/transducer.py:257-330). Returns the best tokens."""
    from ..decode.search import DecodeResult, attention_rescoring

    nbest = [b.hyp[1:] for b in beams]
    res = DecodeResult(tokens=nbest[0] if nbest else [], nbest=nbest,
                       nbest_scores=[b.score for b in beams],
                       nbest_times=[[] for _ in beams])
    with torch.inference_mode():
        out = attention_rescoring(model, cfg, [res], encoder_out[None],
                                  np.asarray([encoder_out.shape[0]]), ctc_weight=0.0,
                                  reverse_weight=reverse_weight)
    return out[0].tokens
