"""The recipe twins (``examples/*/run_torch.sh``) end to end on the CPU with
``device=cpu``, held against the JAX package's tools and CLIs.

Data: the four 0.5 s WAVs of ``tests/test_torch_train_cli.py``'s micro data
(the same draws), listed 40 times over in a key/wav/txt TSV, so that stage
0's split (5% dev, 5% test) leaves 2 dev and 2 test utterances. Configs:
the micro config of that file (one block, 32 d, static batches of 2) with
a JSON CMVN, and the heads each recipe's last stage needs: the 1 + 1-block
attention decoder for CTC's ``attention_rescoring`` (ctc_weight 0.3), an
RNN predictor, joint and decoder for the transducer's ``rnnt_*`` modes, two
classification tasks. ``max_epoch`` 2 gives stage 4 its two checkpoints.

- CTC, stages 0-6 at ``avg_num=2``: the CMVN file equals
  ``tools/compute_cmvn_stats.py``'s on the same list (per-frame mean and
  mean square at the 1e-5 bar ``tests/test_torch_data.py`` holds
  ``compute_fbank_numpy`` to; frame counts equal); the export holds the
  ``avg_2`` average; the stage 6 result files equal ``python -m
  chunkformer_tpu.bin.recognize`` on that export byte for byte, with the
  same modes at ``--chunk_size 0 --left_context_size 0
  --right_context_size 0`` (the JAX CLI raises at its own default, ROADMAP
  C8; the port maps chunk <= 0 to full context).
- CTC stages 3-5 again at ``avg_num=3`` and ``max_epoch`` 3: the export is
  ``avg_3`` (``run.sh:110`` loads ``avg_5`` whatever ``avg_num`` is, C20).
- rnnt, stages 0-6: the same, with the three ``rnnt_*`` modes.
- classification, stages 1-5 on JSONL lists with label columns (stage 0's
  ``tsv_to_list`` writes no label columns, in ``run.sh`` as here): its
  prediction TSV equals ``chunkformer_tpu.bin.classify``'s on the same
  export and list byte for byte. The twin's export names each class by its
  id in a list, the form ``classify_predict`` indexes; ``run.sh``'s
  ``{name: id}`` dicts make the JAX classify raise (C21).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from chunkformer_tpu.bin import classify as jax_classify
from chunkformer_tpu.bin import recognize as jax_recognize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = ["--chunk_size", "0", "--left_context_size", "0", "--right_context_size", "0"]
ENC = {"output_size": 32, "attention_heads": 2, "linear_units": 64, "num_blocks": 1,
       "cnn_module_norm": "layer_norm", "dynamic_conv": True}
DEC = {"attention_heads": 2, "linear_units": 64, "num_blocks": 1, "r_num_blocks": 1}
COMMON = {
    "encoder": "chunkformer", "encoder_conf": ENC,
    "cmvn": "global_cmvn", "cmvn_conf": {"is_json_cmvn": True},
    "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "dither": 0.0},
                     "filter_conf": {"max_length": 2000},
                     "batch_conf": {"batch_type": "static", "batch_size": 2},
                     "shuffle": False, "sort": False},
    "max_epoch": 2, "log_interval": 1, "optim": "adam", "optim_conf": {"lr": 0.001},
    "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 5},
}
CONFIGS = {
    "ctc": {**COMMON, "model": "asr_model", "decoder": "bitransformer", "decoder_conf": DEC,
            "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3}},
    "rnnt": {**COMMON, "model": "transducer", "predictor": "rnn",
             "predictor_conf": {"embed_size": 32, "output_size": 32, "hidden_size": 32,
                                "num_layers": 1},
             "joint_conf": {"join_dim": 48, "pred_output_size": 32},
             "decoder": "bitransformer", "decoder_conf": DEC,
             "model_conf": {"transducer_weight": 0.75, "ctc_weight": 0.1,
                            "attention_weight": 0.15, "enable_k2": True, "prune_range": 5}},
    "classification": {**COMMON, "model": "classification",
                       "model_conf": {"tasks": {"gender": 2, "emotion": 3}}},
}
TEXTS = ["ab ba", "ba", "ab", "a b ab"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The micro WAVs, a 40-row TSV over them, the configs."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    wavs = []
    for i in range(4):
        wav = root / f"w{i}.wav"
        wavfile.write(str(wav), 16000, (rng.normal(size=8000) * 3000).astype(np.int16))
        wavs.append(str(wav))
    rows = ["key\twav\ttxt"] + [f"u{i:02d}\t{wavs[i % 4]}\t{TEXTS[i % 4]}" for i in range(40)]
    (root / "train.tsv").write_text("\n".join(rows) + "\n")
    for name, cfg in CONFIGS.items():
        (root / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
        (root / f"{name}-3.yaml").write_text(yaml.safe_dump({**cfg, "max_epoch": 3}))
    # the classification lists: JSONL with label columns
    for name, keys in (("train", range(36)), ("dev", range(36, 38)), ("test", range(38, 40))):
        lines = [json.dumps({"key": f"u{i:02d}", "wav": wavs[i % 4], "label_gender": i % 2,
                             "label_emotion": i % 3}) for i in keys]
        (root / f"cls_{name}.list").write_text("\n".join(lines) + "\n")
    return root


def _recipe(example, corpus, tmp, **env):
    """Run ``examples/<example>/run_torch.sh`` with data and exp under
    ``tmp``; returns its output."""
    script = os.path.join(REPO, "examples", example, "run_torch.sh")
    full = {**os.environ, "data": str(tmp / "data"), "exp": str(tmp / "exp"),
            "train_tsv": str(corpus / "train.tsv"), "device": "cpu", "OMP_NUM_THREADS": "2",
            **{k: str(v) for k, v in env.items()}}
    os.makedirs(tmp / "data", exist_ok=True)
    out = subprocess.run(["bash", script], env=full, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return out.stdout


def _stages(stdout):
    return [int(line.split()[1].rstrip(":")) for line in stdout.splitlines()
            if line.startswith("stage ")]


def _same_files(got_dir, want_dir, names):
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as g, \
                open(os.path.join(want_dir, name), "rb") as w:
            assert g.read() == w.read(), name


def _export_holds(exp, tag):
    """The export's weights are the checkpoint ``tag``'s."""
    from chunkformer_tpu_torch.train.checkpoint import load_checkpoint

    state = load_checkpoint(str(exp), tag)[0]
    exported = torch.load(str(exp / "export" / "pytorch_model.bin"), weights_only=True)
    assert exported.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(exported[k], v.float() if v.is_floating_point() else v), k


@pytest.fixture(scope="module")
def ctc(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ctc")
    out = _recipe("asr/ctc", corpus, tmp, config=corpus / "ctc.yaml", avg_num=2)
    return tmp, out


def test_ctc_recipe_cmvn_export_and_results_equal_jax(ctc, tmp_path):
    tmp, out = ctc
    assert _stages(out) == [0, 1, 2, 3, 4, 5, 6]
    data, exp = tmp / "data", tmp / "exp"
    assert len((data / "internal_test.list").read_text().splitlines()) == 2
    # the CMVN file against the JAX tool's on the same list
    want = tmp_path / "global_cmvn"
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "compute_cmvn_stats.py"),
                    "--in_list", str(data / "train.list"), "--out_cmvn", str(want),
                    "--num_workers", "2"], check=True, capture_output=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    got, want = (json.loads((data / "train" / "global_cmvn").read_text()),
                 json.loads(want.read_text()))
    assert got["frame_num"] == want["frame_num"] == 36 * 48
    for k in ("mean_stat", "var_stat"):
        np.testing.assert_allclose(np.asarray(got[k]) / got["frame_num"],
                                   np.asarray(want[k]) / want["frame_num"], atol=1e-5, rtol=0)
    _export_holds(exp, "avg_2")
    # stage 6 against the JAX CLI on the recipe's export, at explicit chunk 0
    modes = ["ctc_greedy_search", "attention_rescoring"]
    assert jax_recognize.main(["--model_checkpoint", str(exp / "export"), "--test_data",
                               str(data / "internal_test.list"), "--modes", *modes, *ZERO,
                               "--result_dir", str(tmp_path / "jax")]) == 0
    _same_files(exp / "results", tmp_path / "jax", [f"{m}.txt" for m in modes])


def test_ctc_recipe_exports_the_avg_num_average(ctc, corpus):
    """Stages 3-5 at avg_num=3 over three epochs export ``avg_3`` (C20:
    ``run.sh`` loads ``avg_5`` whatever avg_num is)."""
    tmp, _ = ctc
    exp = tmp / "exp3"
    out = _recipe("asr/ctc", corpus, tmp, config=corpus / "ctc-3.yaml", avg_num=3, stage=3,
                  stop_stage=5, exp=exp)
    assert _stages(out) == [3, 4, 5]
    assert (exp / "avg_3.pt").exists() and not (exp / "avg_5.pt").exists()
    assert "exported avg_3" in out
    _export_holds(exp, "avg_3")


def test_rnnt_recipe_results_equal_jax(corpus, tmp_path):
    out = _recipe("asr/rnnt", corpus, tmp_path, config=corpus / "rnnt.yaml", avg_num=2)
    assert _stages(out) == [0, 1, 2, 3, 4, 5, 6]
    exp, data = tmp_path / "exp", tmp_path / "data"
    _export_holds(exp, "avg_2")
    modes = ["rnnt_greedy_search", "rnnt_beam_search", "rnnt_beam_attn_rescoring"]
    assert jax_recognize.main(["--model_checkpoint", str(exp / "export"), "--test_data",
                               str(data / "internal_test.list"), "--modes", *modes, *ZERO,
                               "--result_dir", str(tmp_path / "jax")]) == 0
    _same_files(exp / "results", tmp_path / "jax", [f"{m}.txt" for m in modes])


def test_classification_recipe_predictions_equal_jax(corpus, tmp_path):
    data = tmp_path / "data"
    os.makedirs(data, exist_ok=True)
    for name, target in (("train", "train"), ("dev", "dev"), ("test", "internal_test")):
        (data / f"{target}.list").write_text((corpus / f"cls_{name}.list").read_text())
    out = _recipe("classification", corpus, tmp_path, config=corpus / "classification.yaml",
                  stage=1)
    assert _stages(out) == [1, 2, 3, 4, 5]
    exp = tmp_path / "exp"
    # no average stage in this recipe: the export is the last epoch's
    assert "exported epoch_1" in out
    _export_holds(exp, "epoch_1")
    mapping = json.loads((exp / "export" / "label_mapping.json").read_text())
    assert mapping == {"gender": ["0", "1"], "emotion": ["0", "1", "2"]}
    argv = ["--test_data", str(data / "internal_test.list"), "--format", "tsv"]
    want = tmp_path / "jax.tsv"
    assert jax_classify.main(["--model_checkpoint", str(exp / "export"), *argv,
                              "--output_file", str(want)]) == 0
    assert (exp / "predictions.tsv").read_bytes() == want.read_bytes()
    # run.sh's mapping, {task: {name: id}}, makes the JAX classify raise (C21)
    shutil.copytree(exp / "export", tmp_path / "jax_recipe_export")
    (tmp_path / "jax_recipe_export" / "label_mapping.json").write_text(json.dumps(
        {"gender": {"0": 0, "1": 1}, "emotion": {"0": 0, "1": 1, "2": 2}}))
    with pytest.raises(KeyError):
        jax_classify.main(["--model_checkpoint", str(tmp_path / "jax_recipe_export"), *argv,
                           "--output_file", str(tmp_path / "jax_recipe.tsv")])
