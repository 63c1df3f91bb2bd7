"""Checkpoint save/load/resume and averaging (counterpart of
``chunkformer_tpu/train/checkpoint.py``; reference chunkformer/utils/checkpoint.py:26-112,
bin/average_model.py:55-115).

A checkpoint is ``<model_dir>/<tag>.pt`` (``torch.save`` of the model's
state dict, and the optimizer's and the scheduler's where given) plus the
JAX package's ``<tag>.yaml`` sidecar: epoch, step, cv_loss, save_time, tag.
The model's state dict has the reference names (``encoder.``, ``ctc.``,
``decoder.``, ...), so an export or ``load_trained_modules`` reads it by
name.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


def _path(model_dir: str, tag: str) -> str:
    return os.path.join(model_dir, f"{tag}.pt")


def save_checkpoint(model_dir: str, tag: str, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict] = None,
                    scheduler_state: Optional[Dict] = None,
                    info_dict: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<dir>/<tag>.pt`` and the ``<tag>.yaml`` sidecar (reference
    checkpoint.py:57-89); tensors go to the CPU first. Returns the .pt path."""
    import yaml

    os.makedirs(model_dir, exist_ok=True)
    blob: Dict[str, Any] = {"model": {k: v.detach().cpu() for k, v in model_state.items()}}
    if optimizer_state is not None:
        blob["optimizer"] = optimizer_state
    if scheduler_state is not None:
        blob["scheduler"] = scheduler_state
    path = _path(model_dir, tag)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    info = dict(info_dict or {})
    info["tag"] = tag
    with open(os.path.join(model_dir, f"{tag}.yaml"), "w") as f:
        yaml.safe_dump(info, f)
    return path


def load_checkpoint(model_dir: str, tag: str) -> Tuple[Dict[str, torch.Tensor],
                                                       Optional[Dict], Optional[Dict],
                                                       Dict[str, Any]]:
    """Returns (model state, optimizer state | None, scheduler state | None,
    info) on the CPU (reference checkpoint.py:26-54)."""
    import yaml

    blob = torch.load(_path(model_dir, tag), map_location="cpu", weights_only=True)
    info: Dict[str, Any] = {}
    side = os.path.join(model_dir, f"{tag}.yaml")
    if os.path.exists(side):
        with open(side) as f:
            info = yaml.safe_load(f) or {}
    return blob["model"], blob.get("optimizer"), blob.get("scheduler"), info


def list_checkpoints(model_dir: str) -> List[Dict[str, Any]]:
    """Every tag with a checkpoint and a sidecar, sorted by step."""
    import yaml

    out = []
    for side in glob.glob(os.path.join(model_dir, "*.yaml")):
        tag = os.path.splitext(os.path.basename(side))[0]
        if tag == "train":  # merged config dump, not a checkpoint
            continue
        if not os.path.exists(_path(model_dir, tag)):
            continue
        with open(side) as f:
            info = yaml.safe_load(f) or {}
        info.setdefault("tag", tag)
        out.append(info)
    out.sort(key=lambda d: d.get("step", 0))
    return out


def average_checkpoints(model_dir: str, num: int = 5, mode: str = "best",
                        min_step: int = 0) -> Dict[str, torch.Tensor]:
    """Average the best ``num`` (by cv_loss) or the last ``num`` checkpoints
    at step >= ``min_step`` (reference bin/average_model.py:55-115): floating
    tensors (batch-norm running statistics included) summed in float64 and
    returned in float32; integer buffers from the newest chosen checkpoint."""
    ckpts = [c for c in list_checkpoints(model_dir) if c.get("step", 0) >= min_step]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {model_dir}")
    if mode == "best":
        scored = sorted((c for c in ckpts if "cv_loss" in c), key=lambda d: d["cv_loss"])
        chosen = scored[:num] if scored else ckpts[-num:]
    else:
        chosen = ckpts[-num:]
    newest = max(chosen, key=lambda d: d.get("step", 0))["tag"]
    acc: Dict[str, torch.Tensor] = {}
    ints: Dict[str, torch.Tensor] = {}
    for c in chosen:
        state = load_checkpoint(model_dir, c["tag"])[0]
        for k, v in state.items():
            if v.is_floating_point():
                acc[k] = acc[k] + v.double() if k in acc else v.double()
            elif c["tag"] == newest:
                ints[k] = v
    out = {k: (v / len(chosen)).float() for k, v in acc.items()}
    out.update(ints)
    return out


def load_trained_modules(model: torch.nn.Module, init_dir: str, init_tag: str,
                         module_patterns: Sequence[str]) -> torch.nn.Module:
    """Partial init from a pretrained checkpoint (reference checkpoint.py:92-112,
    --enc_init / --enc_init_mods): copy every tensor whose dot name matches
    one of the regexes and whose shape is the model's."""
    src = load_checkpoint(init_dir, init_tag)[0]
    pats = [re.compile(p) for p in module_patterns if p]
    own = model.state_dict()
    take = {k: v for k, v in src.items()
            if any(p.search(k) for p in pats) and k in own and own[k].shape == v.shape}
    own.update(take)
    model.load_state_dict(own, strict=True)
    return model
