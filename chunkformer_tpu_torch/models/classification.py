"""Multi-task speech classification model (counterpart of
``chunkformer_tpu/models/classification.py``; reference:
chunkformer/modules/classification_model.py:25-291): per-task classification
heads over the masked mean of the encoder output.

Parameter names are the reference state-dict names (``encoder.*``,
``classification_heads.<task>.linear.*``; ``chunkformer_tpu/export.py:154``
writes them), so an exported classification ``pytorch_model.bin`` loads with
``strict=True``. ``classification_loss`` is the training loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..config import ChunkFormerConfig
from ..nn.encoder import ChunkFormerEncoder
from ..nn.layers import dropout


class ClassificationHead(nn.Module):
    """The linear layer of Dropout -> Linear (``init_classification_head`` /
    ``classification_head_forward``; reference classification_model.py:25-52);
    ``classify_forward`` applies the dropout in training."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        self.linear = nn.Linear(input_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class ClassificationModel(nn.Module):
    """The encoder and one head per task of ``classification_conf.tasks``."""

    def __init__(self, config: ChunkFormerConfig, cmvn: bool = True):
        super().__init__()
        self.encoder = ChunkFormerEncoder(config.encoder_conf, cmvn)
        self.head_dropout = config.classification_conf.get("head_dropout", 0.1)
        tasks: Dict[str, int] = config.classification_conf.get("tasks", {})
        self.classification_heads = nn.ModuleDict({
            name: ClassificationHead(config.encoder_conf.output_size, n)
            for name, n in sorted(tasks.items())})


def masked_average_pooling(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D] x [B, T] (True = valid) -> [B, D] (classification_model.py:174-196)."""
    m = mask[:, :, None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def classify_forward(model: ClassificationModel, feats: torch.Tensor, feats_lens: torch.Tensor,
                     chunk_size: int = 0, left_context_size: int = 0,
                     right_context_size: int = 0, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Per-task logits [B, n_classes] in sorted task order
    (classification_model.py:199-291): feats [B, T, feat] and feats_lens [B]
    on the model's device; chunk_size > 0 runs the encoder at limited
    context (c, L, R). In training the encoder and the heads' dropout
    (``classification_conf.head_dropout``) draw from ``generator``."""
    from ..train.losses import generator_on

    enc_out, enc_mask = model.encoder.forward_train(
        feats, feats_lens, chunk_size, left_context_size, right_context_size, train,
        generator)
    pooled = masked_average_pooling(enc_out, enc_mask)
    gen = generator_on(generator, feats.device, train)
    rate = model.head_dropout
    return {name: head(dropout(pooled, rate, gen))
            for name, head in sorted(model.classification_heads.items())}


def classification_loss(model: ClassificationModel, cfg: ChunkFormerConfig,
                        feats: torch.Tensor, feats_lens: torch.Tensor,
                        labels: Dict[str, torch.Tensor], target_lens=None,
                        chunk_size: int = 0, left_context_size: int = 0,
                        right_context_size: int = 0, train: bool = True,
                        generator: Optional[torch.Generator] = None,
                        step: int = 0) -> Dict[str, torch.Tensor]:
    """Per-task label-smoothed cross entropy and accuracy
    (classification_model.py:102-171): loss_<task>, acc_<task> and their
    mean loss. ``labels`` is {task: [B] class ids}; ``target_lens`` and
    ``step`` are unused (the loss functions share one signature)."""
    lsm = cfg.model_conf.lsm_weight
    logits = classify_forward(model, feats, feats_lens, chunk_size, left_context_size,
                              right_context_size, train, generator)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=feats.device)
    for name, lg in logits.items():
        y = labels[name].long()
        v = lg.shape[-1]
        logp = torch.log_softmax(lg.float(), dim=-1)
        smoothed = torch.nn.functional.one_hot(y, v).float() * (1 - lsm) + lsm / v
        loss = -(smoothed * logp).sum(-1).mean()
        metrics[f"loss_{name}"] = loss
        metrics[f"acc_{name}"] = (lg.argmax(-1) == y).float().mean()
        total = total + loss
    metrics["loss"] = total / max(len(logits), 1)
    return metrics


@torch.inference_mode()
def classify_predict(model: ClassificationModel, feats: torch.Tensor, feats_lens: torch.Tensor,
                     label_mapping: Optional[Dict[str, List[str]]] = None,
                     **kw) -> Dict[str, Dict]:
    """Inference on the first utterance: per-task {label, label_id, prob}
    (chunkformer_model.py:554-646). The softmax runs in float32; the label is
    ``label_mapping[task][idx]`` where the mapping has the task, else
    ``str(idx)``."""
    logits = classify_forward(model, feats, feats_lens, **kw)
    out: Dict[str, Dict] = {}
    for name, lg in logits.items():
        probs = torch.softmax(lg.float(), dim=-1)[0]
        idx = int(probs.argmax())
        label = (label_mapping[name][idx]
                 if label_mapping and name in label_mapping else str(idx))
        out[name] = {"label": label, "label_id": idx, "prob": float(probs[idx])}
    return out
