#!/usr/bin/env python3
"""Push an exported model directory to the Hugging Face Hub, with a model
card for chunkformer_tpu_torch (the twin of tools/push_model_hf.py;
reference: tools/push_model_hf.py, ChunkFormerHubUploader).

Generates a model card and uploads config.yaml / pytorch_model.bin /
vocab.txt [/ global_cmvn / label_mapping.json]. Requires `huggingface_hub`
and network access.

  python tools/push_torch_model_hf.py --model_dir exp/export --repo_id user/name
"""

import argparse
import os
import sys

CARD_TEMPLATE = """---
license: apache-2.0
tags:
- automatic-speech-recognition
- chunkformer
- long-form-transcription
- pytorch
- cuda
---

# {repo_id}

ChunkFormer model exported from **chunkformer_tpu_torch** (PyTorch with
hand-written CUDA kernels for the NVIDIA H100). The checkpoint uses the
reference-compatible export layout; download the repository into a
directory and load it from there:

```python
from chunkformer_tpu_torch.api import ChunkFormerModel
model = ChunkFormerModel.from_pretrained("path/to/{name}")  # on the card
print(model.endless_decode("audio.wav", return_timestamps=False))
```
"""


def model_card(repo_id: str) -> str:
    return CARD_TEMPLATE.format(repo_id=repo_id, name=repo_id.rsplit("/", 1)[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_dir", required=True, help="exported model directory")
    ap.add_argument("--repo_id", required=True, help="e.g. user/chunkformer-ctc-large")
    ap.add_argument("--private", action="store_true")
    args = ap.parse_args(argv)

    try:
        from huggingface_hub import HfApi
    except ImportError:
        print("huggingface_hub is not installed", file=sys.stderr)
        return 2

    card = os.path.join(args.model_dir, "README.md")
    if not os.path.exists(card):
        with open(card, "w") as f:
            f.write(model_card(args.repo_id))

    api = HfApi()
    api.create_repo(args.repo_id, private=args.private, exist_ok=True)
    api.upload_folder(folder_path=args.model_dir, repo_id=args.repo_id)
    print(f"pushed {args.model_dir} -> https://huggingface.co/{args.repo_id}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
