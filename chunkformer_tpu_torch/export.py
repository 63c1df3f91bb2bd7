"""Export a trained model to a reference-format directory (counterpart of
``chunkformer_tpu/export.py``; reference examples/asr/ctc/run.sh:206-271,
chunkformer_model.py:145-206).

The inverse of ``convert.py``: the port's state dict already has the
reference names, so the export writes it as it is, in float32 (integer
buffers as they are): ``config.yaml``, ``pytorch_model.bin``, ``vocab.txt``
and, for a classification model, ``label_mapping.json``. Both packages'
``from_pretrained`` load the directory. It covers the encoder (CMVN
included), the CTC head, the attention decoder, the transducer's predictor,
joint and simple-joint projections, and the classification heads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import torch


def export_model_dir(out_dir: str, config_dict: Dict[str, Any],
                     model: Union[torch.nn.Module, Dict[str, torch.Tensor]],
                     symbol_table: Optional[Dict[str, int]] = None,
                     label_mapping: Optional[Dict] = None) -> str:
    """Write a reference-format export directory of ``model`` (a module or
    its state dict); returns ``out_dir``."""
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config_dict, f)
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    sd = {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().contiguous()
          for k, v in sd.items()}
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    if symbol_table:
        with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            for sym, idx in sorted(symbol_table.items(), key=lambda kv: kv[1]):
                f.write(f"{sym} {idx}\n")
    if label_mapping:
        with open(os.path.join(out_dir, "label_mapping.json"), "w") as f:
            json.dump(label_mapping, f, ensure_ascii=False, indent=2)
    return out_dir
