"""The port's classification path against the JAX package on the CPU: the
config's reference-schema moves (``model_conf.tasks``, ``dropout_rate``,
``label_smoothing``), the export with its ``label_mapping.json``,
``classify_forward``, ``classify_audio`` and the classify CLI.

A random tiny JAX classification model (2 layers, 64 d, 4 heads, four tasks)
is exported with ``chunkformer_tpu/export.py:160 export_model_dir`` and
loaded by both packages; the in-memory carry ``state_dict_from_jax_params``
must equal the export. Logits are held at f32 atol 1e-5, labels and ids
exactly, probabilities at rtol 1e-5, the TSV byte for byte.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.bin import classify as jax_classify
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.classification import classify_forward as jax_classify_forward
from chunkformer_tpu.models.classification import init_classification_model
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.bin import classify
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import load_state_dict, state_dict_from_jax_params
from chunkformer_tpu_torch.models.classification import classify_forward

from .test_torch_api import REPO, TINY, _speechlike

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TASKS = {"gender": 2, "emotion": 8, "dialect": 5, "age": 5}
LABELS = {"gender": ["male", "female"],
          "emotion": ["neu", "hap", "sad", "ang", "sur", "fea", "dis", "con"],
          "dialect": ["north", "central", "south", "highland", "other"]}  # age: ids
BASE = {k: v for k, v in TINY.items() if k not in ("ctc_conf", "output_dim")}
BASE["encoder_conf"] = {**BASE["encoder_conf"], "dynamic_conv": True}
SCHEMAS = {  # the reference's multi_task.yaml schema, and classification_conf
    "model_conf": {**BASE, "model": "classification",
                   "model_conf": {"tasks": TASKS, "dropout_rate": 0.2, "label_smoothing": 0.1}},
    "classification_conf": {**BASE, "model": "classification",
                            "classification_conf": {"tasks": TASKS, "head_dropout": 0.3},
                            "model_conf": {"lsm_weight": 0.2}},
}
ATOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both schemas' exports of one random model, three WAVs and a test list."""
    root = tmp_path_factory.mktemp("torch_classification")
    rng = np.random.default_rng(5)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_classification_model(
        jax.random.PRNGKey(5), JaxConfig.from_dict(SCHEMAS["model_conf"]), cmvn))
    dirs = {name: export_model_dir(str(root / name), d, params, label_mapping=LABELS)
            for name, d in SCHEMAS.items()}
    rows, wavs = [], []
    for i, seconds in enumerate((2.7, 1.4, 3.6)):
        path = str(root / f"c{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        wavs.append(path)
        rows.append(f"utt{i}\t{path}")
    test_list = root / "test.list"
    test_list.write_text("\n".join(rows) + "\n", encoding="utf-8")
    d = dirs["model_conf"]
    return dict(root=root, dirs=dirs, params=params, wavs=wavs, test_list=str(test_list),
                jm=JaxModel.from_pretrained(d),
                tm=ChunkFormerModel.from_pretrained(d, device="cpu"))


def _common_fields(a, b):
    names = {f.name for f in dataclasses.fields(b)}
    return ({f.name: getattr(a, f.name) for f in dataclasses.fields(a) if f.name in names},
            {n: getattr(b, n) for n in names if hasattr(a, n)})


@pytest.mark.parametrize("schema", [*SCHEMAS, "multi_task.yaml"])
def test_config_matches_jax(schema):
    """Both schemas and examples/classification/conf/multi_task.yaml parse to
    the JAX config's values (model, classification_conf, model_conf and
    encoder_conf fields the port has)."""
    if schema == "multi_task.yaml":
        path = os.path.join(REPO, "examples", "classification", "conf", "multi_task.yaml")
        got, want = ChunkFormerConfig.from_yaml(path), JaxConfig.from_yaml(path)
        assert got.classification_conf == {"tasks": TASKS, "head_dropout": 0.1}
        assert got.model_conf.lsm_weight == 0.2
    else:
        got = ChunkFormerConfig.from_dict(copy.deepcopy(SCHEMAS[schema]))
        want = JaxConfig.from_dict(copy.deepcopy(SCHEMAS[schema]))
    assert got.model == want.model == "classification"
    assert got.classification_conf == want.classification_conf
    assert got.classification_conf["tasks"] == TASKS
    for port_part, jax_part in ((got.model_conf, want.model_conf),
                                (got.encoder_conf, want.encoder_conf)):
        a, b = _common_fields(port_part, jax_part)
        assert a == b


@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_export_loads_with_its_heads(setup, schema):
    """Either schema's export loads strictly as a classification model (no
    CTC head), with its label mapping; its weights equal the in-memory carry
    of the JAX parameters and the export's file."""
    tm = ChunkFormerModel.from_pretrained(setup["dirs"][schema], device="cpu")
    assert tm.is_classification and not tm.is_transducer
    assert not hasattr(tm.model, "ctc") and tm.label_mapping == LABELS
    assert list(tm.model.classification_heads) == sorted(TASKS)
    carried = state_dict_from_jax_params(setup["params"],
                                         ChunkFormerConfig.from_dict(SCHEMAS[schema]))
    exported = load_state_dict(os.path.join(setup["dirs"][schema], "pytorch_model.bin"))
    got = tm.model.state_dict()
    assert carried.keys() == exported.keys() == got.keys()
    assert sum(k.startswith("classification_heads.") for k in got) == 2 * len(TASKS)
    for k, v in exported.items():
        assert torch.equal(carried[k], v) and torch.equal(got[k], v), k


@pytest.mark.parametrize("chunk", [(0, 0, 0), (8, 16, 16)])
def test_classify_forward_matches_jax(setup, chunk):
    """Per-task logits of a padded batch of three, at full context and at
    (8, 16, 16) against JAX's XLA path and its Pallas training kernel in
    interpret mode: f32 atol 1e-5, tasks in the same (sorted) order."""
    jm, tm = setup["jm"], setup["tm"]
    rng = np.random.default_rng(6)
    xs = rng.normal(10.0, 2.0, size=(3, 311, 80)).astype(np.float32)
    lens = np.array([311, 274, 190], np.int32)
    with torch.inference_mode():
        got = classify_forward(tm.model, torch.from_numpy(xs), torch.from_numpy(lens), *chunk)
    pallas = copy.deepcopy(jm.config)
    pallas.encoder_conf.use_pallas_train = True
    pallas.encoder_conf.pallas_interpret = True
    for cfg in (jm.config, pallas):
        want = jax_classify_forward(jm.params, cfg, jnp.asarray(xs), jnp.asarray(lens), *chunk)
        assert list(got) == list(want) == sorted(TASKS)
        for task, lg in want.items():
            np.testing.assert_allclose(got[task].numpy(), np.asarray(lg), atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [(-1, -1, -1), (8, 16, 16)])
def test_classify_audio_matches_jax(setup, chunk):
    """``classify_audio`` on each file: labels (from the mapping, and
    ``str(idx)`` for the unmapped task) and ids identical, probs rtol 1e-5."""
    jm, tm = setup["jm"], setup["tm"]
    for wav in setup["wavs"]:
        got, want = tm.classify_audio(wav, *chunk), jm.classify_audio(wav, *chunk)
        assert list(got) == list(want) == sorted(TASKS)
        for task in want:
            assert got[task]["label"] == want[task]["label"]
            assert got[task]["label_id"] == want[task]["label_id"]
            np.testing.assert_allclose(got[task]["prob"], want[task]["prob"], rtol=1e-5)
        assert got["age"]["label"] == str(got["age"]["label_id"])


@pytest.mark.parametrize("fmt", ["tsv", "jsonl"])
def test_classify_cli_matches_jax(setup, fmt):
    """``bin/classify.main`` with ``--device cpu``: the TSV byte for byte
    equal to the JAX CLI's; JSONL with the same keys, labels and ids, and
    probs within rtol 1e-5."""
    root = setup["root"]
    argv = ["--model_checkpoint", setup["dirs"]["classification_conf"],
            "--test_data", setup["test_list"], "--format", fmt]
    want_path, got_path = str(root / f"jax.{fmt}"), str(root / f"torch.{fmt}")
    assert jax_classify.main([*argv, "--output_file", want_path]) == 0
    assert classify.main([*argv, "--output_file", got_path, "--device", "cpu"]) == 0
    want = open(want_path, encoding="utf-8").read()
    got = open(got_path, encoding="utf-8").read()
    if fmt == "tsv":
        assert got == want and want.splitlines()[0] == "key\t" + "\t".join(sorted(TASKS))
        assert len(want.splitlines()) == 4
        return
    rows = [(json.loads(g), json.loads(w)) for g, w in zip(got.splitlines(),
                                                           want.splitlines(), strict=True)]
    assert len(rows) == 3
    for g, w in rows:
        assert list(g) == list(w) and g["key"] == w["key"]
        for task in TASKS:
            assert (g[task]["label"], g[task]["label_id"]) == (w[task]["label"],
                                                               w[task]["label_id"])
            np.testing.assert_allclose(g[task]["prob"], w[task]["prob"], rtol=1e-5)
