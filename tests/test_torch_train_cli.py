"""The port's train and average_model CLIs and its export on the CPU.

- ``bin/train.py`` ``main(argv)`` with ``--device cpu`` on the micro config
  and data of ``tests/test_clis.py:test_train_cli_smoke`` (one block, 32 d;
  four 0.5 s WAVs): ``train.yaml``, ``metrics.jsonl``, ``epoch_N`` and its
  sidecar; ``--checkpoint`` resumes at the next epoch with the saved step
  and optimizer state; ``bin/average_model.py`` averages the epochs.
- ``export_model_dir`` of JAX-carried parameters writes the same keys,
  shapes and values (exactly) as ``chunkformer_tpu/export.py:160`` of the
  same parameters, for a CTC/AED model with CMVN and batch norm, a
  transducer and a classification model.
- The JAX package's ``from_pretrained`` of the port's export decodes the
  same tokens as the port's (f32, tiny random model).
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir as jax_export
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.models.classification import init_classification_model
from chunkformer_tpu.models.transducer import init_transducer
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.bin import average_model, train
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import load_state_dict, state_dict_from_jax_params
from chunkformer_tpu_torch.export import export_model_dir
from chunkformer_tpu_torch.models.asr import ASRModel
from chunkformer_tpu_torch.models.classification import ClassificationModel
from chunkformer_tpu_torch.models.transducer import TransducerModel
from chunkformer_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint

from .test_torch_api import TINY, _speechlike
from .test_torch_search import HYBRID
from .test_torch_transducer import RNNT


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The data and config of test_clis.py's train smoke, at two epochs."""
    data = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        wav = data / f"w{i}.wav"
        wavfile.write(str(wav), 16000, (rng.normal(size=8000) * 3000).astype(np.int16))
        lines.append(f"u{i}\t{wav}\tab ba\n")
    for name, ls in (("train.list", lines), ("dev.list", lines[:2])):
        (data / name).write_text("".join(ls))
    units = data / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\na 2\nb 3\n▁ 4\n<sos/eos> 5\n")
    cfg = {
        "encoder": "chunkformer",
        "encoder_conf": {"output_size": 32, "attention_heads": 2, "linear_units": 64,
                         "num_blocks": 1, "cnn_module_norm": "layer_norm",
                         "dynamic_conv": True},
        "model": "asr_model",
        "model_conf": {"ctc_weight": 1.0},
        "tokenizer": "char",
        "tokenizer_conf": {"symbol_table_path": str(units)},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "dither": 0.0},
                         "filter_conf": {"max_length": 2000},
                         "batch_conf": {"batch_type": "static", "batch_size": 2},
                         "shuffle": False, "sort": False},
        "max_epoch": 2,
        "log_interval": 1,
        "optim": "adam",
        "optim_conf": {"lr": 0.001},
        "scheduler": "warmuplr",
        "scheduler_conf": {"warmup_steps": 5},
    }
    (data / "conf.yaml").write_text(yaml.safe_dump(cfg))
    return data


def _argv(data, exp, *extra):
    return ["--config", str(data / "conf.yaml"), "--train_data", str(data / "train.list"),
            "--cv_data", str(data / "dev.list"), "--model_dir", str(exp), "--device", "cpu",
            *extra]


def test_train_cli_resume_and_average(micro, tmp_path):
    exp = tmp_path / "exp"
    assert train.main(_argv(micro, exp, "--override_config", "max_epoch 1")) == 0
    for name in ("train.yaml", "metrics.jsonl", "epoch_0.pt", "epoch_0.yaml"):
        assert (exp / name).exists(), name
    assert yaml.safe_load((exp / "train.yaml").read_text())["output_dim"] == 6
    info = yaml.safe_load((exp / "epoch_0.yaml").read_text())
    assert info["epoch"] == 0 and info["step"] == 2 and np.isfinite(info["cv_loss"])
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2] and all(np.isfinite(x["loss"]) for x in lines)
    _, opt0, _, _ = load_checkpoint(str(exp), "epoch_0")

    ex = train.run(_argv(micro, exp, "--checkpoint", "epoch_0"))
    assert ex.step == 4  # resumed at step 2, two more steps in epoch 1
    assert [c["tag"] for c in list_checkpoints(str(exp))] == ["epoch_0", "epoch_1"]
    _, opt1, sched1, info1 = load_checkpoint(str(exp), "epoch_1")
    assert info1["epoch"] == 1 and info1["step"] == 4 and sched1["last_epoch"] == 4
    assert all(int(s["step"]) == 4 for s in opt1["state"].values())
    assert all(int(s["step"]) == 2 for s in opt0["state"].values())

    assert average_model.main(["--src_path", str(exp), "--num", "2", "--dst_tag", "avg"]) == 0
    avg, _, _, _ = load_checkpoint(str(exp), "avg")
    e0, e1 = load_checkpoint(str(exp), "epoch_0")[0], load_checkpoint(str(exp), "epoch_1")[0]
    k = "ctc.ctc_lo.weight"
    torch.testing.assert_close(avg[k], ((e0[k].double() + e1[k].double()) / 2).float(),
                               atol=0, rtol=0)


def _cmvn(dim=80, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=dim).astype(np.float32),
            (1.0 + 0.1 * rng.random(dim)).astype(np.float32))


def _table(n):
    return {f"t{i}": i for i in range(n)}


@pytest.mark.parametrize("kind", ["hybrid_batch_norm", "transducer", "classification"])
def test_export_matches_jax_export(tmp_path, kind):
    if kind == "hybrid_batch_norm":
        d = {**HYBRID, "encoder_conf": {**HYBRID["encoder_conf"],
                                        "cnn_module_norm": "batch_norm"}}
        init, model_cls, mapping = init_asr_model, ASRModel, None
    elif kind == "transducer":
        d, init, model_cls, mapping = RNNT, init_transducer, TransducerModel, None
    else:
        d = {**TINY, "model": "classification",
             "model_conf": {"tasks": {"gender": 2, "emotion": 3}}}
        init, model_cls = init_classification_model, ClassificationModel
        mapping = {"gender": ["f", "m"], "emotion": ["a", "b", "c"]}
    jcfg = JaxConfig.from_dict(d)
    jcfg.vocab_size = d["output_dim"]
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), jcfg, _cmvn()))
    cfg = ChunkFormerConfig.from_dict(d)
    model = model_cls(cfg, cmvn=True)
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    table = _table(d["output_dim"])
    jax_export(str(tmp_path / "jax"), d, params, table, mapping)
    export_model_dir(str(tmp_path / "port"), d, model, table, mapping)
    want = load_state_dict(str(tmp_path / "jax" / "pytorch_model.bin"))
    got = load_state_dict(str(tmp_path / "port" / "pytorch_model.bin"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    for name in ("config.yaml", "vocab.txt") + (("label_mapping.json",) if mapping else ()):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    loaded = ChunkFormerModel.from_pretrained(str(tmp_path / "port"), device="cpu")
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_jax_serves_the_port_export(tmp_path):
    """A port model exported by the port decodes to the same tokens in both
    packages (endless_decode at (8, 16, 16) over several macro-segments,
    f32)."""
    cfg = ChunkFormerConfig.from_dict(TINY)
    from chunkformer_tpu_torch.models.asr import init_random_

    model = init_random_(ASRModel(cfg, cmvn=True), torch.Generator().manual_seed(9))
    with torch.no_grad():  # speech-like CMVN; without biases no single token wins every frame
        model.encoder.global_cmvn.mean.fill_(10.0)
        model.encoder.global_cmvn.istd.fill_(0.3)
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
    out = export_model_dir(str(tmp_path / "exp"), TINY, model, _table(TINY["output_dim"]))
    wav = tmp_path / "a.wav"
    wavfile.write(str(wav), 16000, _speechlike(np.random.default_rng(4), 6.0))
    kw = dict(chunk_size=8, left_context_size=16, right_context_size=16,
              total_batch_duration=4)
    jm = JaxModel.from_pretrained(out)
    tm = ChunkFormerModel.from_pretrained(out, device="cpu")
    jm.char_dict = tm.char_dict = None
    want = jm.endless_decode(str(wav), **kw)
    got = tm.endless_decode(str(wav), **kw)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    assert len(set(np.asarray(want).tolist())) > 1
