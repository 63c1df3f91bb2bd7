"""Data list sources (counterpart of ``chunkformer_tpu/data/pipeline.py``).

Only ``text_line_source`` is ported (the test lists of the recognize and
alignment CLIs); the training pipeline waits for ROADMAP A16.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator


def text_line_source(path: str) -> Iterator[Dict]:
    """list file: json per line or `key\\twav\\ttxt` (datapipes.py:338-352)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                yield json.loads(line)
            else:
                parts = line.split("\t")
                if len(parts) >= 3:
                    yield {"key": parts[0], "wav": parts[1], "txt": parts[2]}
                elif len(parts) == 2:
                    yield {"key": parts[0], "wav": parts[1]}
