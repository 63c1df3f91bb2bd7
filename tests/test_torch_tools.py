"""The tool twins of the port (``tools/*_torch_*.py``) on the CPU, against
the JAX tools where they have an output to compare.

- ``compute_torch_cmvn_stats.py``: the JSON of ``compute_cmvn_stats.py`` on
  the same list (frame counts equal; per-frame mean and mean square at the
  1e-5 bar of ``compute_fbank_numpy``, ``tests/test_torch_data.py``).
- ``eval_torch_reference_wer.py``: on a random tiny export (2 layers, 64 d)
  and a two-row TSV of synthetic speech with made-up transcripts, it prints
  ``GATE: FAIL`` and returns 1, as the JAX tool exits 1; its per-file
  ``[endless]`` and ``[batch]`` hypotheses are the JAX tool's lines.
- ``push_torch_model_hf.py``: the model card it writes names
  ``chunkformer_tpu_torch.api.ChunkFormerModel`` and the H100, not the
  JAX package or the TPU; ``HfApi`` is replaced by a recorder, so nothing
  is uploaded (the upload needs the network).
- ``train_torch_descent_run.py``: its arguments (120 steps, the card, the
  committed artifact's path by default) and one CPU step at a tiny size,
  whose line has the keys of the JAX artifact's lines.
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model

from .test_torch_api import TINY, _speechlike

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny random export, two WAVs of synthetic speech, a data list and a
    reference TSV."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(4)
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(4),
                                                     JaxConfig.from_dict(TINY)))
    table = {"<blank>": 0, **{f"t{i}▁" if i % 5 == 0 else f"t{i}": i for i in range(1, 64)}}
    model_dir = export_model_dir(str(root / "export"), TINY, params, table)
    wavs = []
    for i, seconds in enumerate((3.1, 2.2)):
        path = root / f"s{i}.wav"
        wavfile.write(str(path), 16000, _speechlike(rng, seconds))
        wavs.append(str(path))
    (root / "data.list").write_text("".join(f"s{i}\t{w}\tx\n" for i, w in enumerate(wavs)))
    (root / "data.tsv").write_text("key\twav\ttxt\n" + "".join(
        f"s{i}\t{w}\thello world\n" for i, w in enumerate(wavs)))
    return root, model_dir


def test_cmvn_twin_equals_the_jax_tool(corpus):
    root, _ = corpus
    out = {}
    for name in ("compute_torch_cmvn_stats.py", "compute_cmvn_stats.py"):
        path = root / f"{name}.json"
        subprocess.run([sys.executable, os.path.join(TOOLS, name), "--in_list",
                        str(root / "data.list"), "--out_cmvn", str(path), "--num_workers", "2"],
                       check=True, capture_output=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
        out[name] = json.loads(path.read_text())
    got, want = out["compute_torch_cmvn_stats.py"], out["compute_cmvn_stats.py"]
    assert got["frame_num"] == want["frame_num"] == 308 + 218
    for k in ("mean_stat", "var_stat"):
        assert len(got[k]) == 80
        np.testing.assert_allclose(np.asarray(got[k]) / got["frame_num"],
                                   np.asarray(want[k]) / want["frame_num"], atol=1e-5, rtol=0)


def _hyps(text):
    return [line for line in text.splitlines() if re.match(r"\[(endless|batch)\]", line)]


def test_wer_gate_twin_fails_as_the_jax_tool_with_its_hypotheses(corpus, capsys,
                                                                  monkeypatch):
    from tools import eval_reference_wer as jax_tool
    from tools import eval_torch_reference_wer as tool

    root, model_dir = corpus
    argv = ["--model", model_dir, "--data", str(root / "data.tsv")]
    assert tool.main([*argv, "--device", "cpu"]) == 1
    got = capsys.readouterr().out
    assert "GATE: FAIL" in got and "endless WER:" in got and "cross-WER" in got
    monkeypatch.setattr(sys, "argv", ["eval_reference_wer.py", *argv])
    with pytest.raises(SystemExit) as exit_info:
        jax_tool.main()
    assert exit_info.value.code == 1
    want = capsys.readouterr().out
    assert len(_hyps(got)) == 4 and _hyps(got) == _hyps(want)


def test_push_twin_card_names_the_port(tmp_path, monkeypatch):
    import huggingface_hub

    from tools import push_torch_model_hf as tool

    calls = []

    class Recorder:
        def create_repo(self, repo_id, private=False, exist_ok=False):
            calls.append(("create_repo", repo_id, private, exist_ok))

        def upload_folder(self, folder_path, repo_id):
            calls.append(("upload_folder", folder_path, repo_id))

    monkeypatch.setattr(huggingface_hub, "HfApi", Recorder)
    assert tool.main(["--model_dir", str(tmp_path), "--repo_id", "someone/cf-small"]) == 0
    card = (tmp_path / "README.md").read_text()
    assert "from chunkformer_tpu_torch.api import ChunkFormerModel" in card
    assert 'ChunkFormerModel.from_pretrained("path/to/cf-small")' in card
    assert "H100" in card and "# someone/cf-small" in card
    assert "chunkformer_tpu.api" not in card and "- tpu" not in card
    assert calls == [("create_repo", "someone/cf-small", False, True),
                     ("upload_folder", str(tmp_path), "someone/cf-small")]


def test_descent_twin_arguments_and_one_cpu_step(tmp_path):
    from tools import train_torch_descent_run as tool

    args = tool.parse_args([])
    assert (args.steps, args.device) == (120, "cuda")
    assert args.out == os.path.join(REPO, "artifacts", "train_descent_torch.jsonl")
    args = tool.parse_args(["150", "--device", "cpu", "--out", "x.jsonl"])
    assert (args.steps, args.device, args.out) == (150, "cpu", "x.jsonl")
    assert tool.FLAGSHIP["encoder_conf"]["num_blocks"] == 17 and tool.DATA == (4, 8, 1200, 24)

    enc = {**tool.FLAGSHIP["encoder_conf"], "output_size": 32, "attention_heads": 2,
           "linear_units": 64, "num_blocks": 1, "dynamic_chunk_sizes": [8, 16],
           "dynamic_left_context_sizes": [8], "dynamic_right_context_sizes": [8]}
    tiny = {**tool.FLAGSHIP, "encoder_conf": enc, "output_dim": 20,
            "decoder_conf": {"attention_heads": 2, "linear_units": 64, "num_blocks": 1,
                             "r_num_blocks": 1}}
    out = tmp_path / "descent.jsonl"
    records = tool.run(tiny, (2, 2, 100, 5), 1, torch.device("cpu"), str(out))
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == records and len(lines) == 1
    with open(os.path.join(REPO, "artifacts", "train_descent.jsonl")) as f:
        jax_line = json.loads(f.readline())
    assert list(lines[0]) == list(jax_line)
    assert lines[0]["step"] == 1 and lines[0]["chunk_cfg"][0] in (8, 16)
    assert all(np.isfinite(lines[0][k]) for k in ("loss", "loss_ctc", "loss_att", "grad_norm"))
