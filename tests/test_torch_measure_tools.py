"""The port's measurement-tool twins on the CPU at a tiny size (64 d, 2
blocks): each ``main(argv)`` with ``--device cpu`` prints one JSON object
as its last line and writes the same with ``--json``.

- ``ablate_torch_step.py``: every variant timed; the "full" variant's
  tokens are the encoder's ``parallel_chunk`` + CTC argmax on the same rows;
  every patched attribute is the original object again after each run.
- ``ablate_torch_train_step.py``: every variant timed; the "full" first
  step's loss equals ``make_train_step``'s on the same model and batch.
- ``bench_torch_endless_breakdown.py``: every phase timed; an instrumented
  walk's tokens equal ``endless_encode_tokens``'s.
- ``bench_torch_pipeline.py``: each variant's utterance and batch counts
  equal the JAX tool's (``tools/bench_pipeline.py``) on the same WAVs.

``bench_torch_scaling.py`` runs under two gloo processes in
``tests/test_torch_row_shard.py``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--d_model", "64", "--num_blocks", "2"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(tool, argv, tmp_path, capsys):
    """The tool's JSON, from its last line and from ``--json``, which agree."""
    path = tmp_path / f"{tool.__name__}.json"
    assert tool.main(argv + ["--json", str(path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(path) as f:
        assert json.load(f) == printed
    assert printed["device"] == "cpu"
    return printed


@pytest.fixture(autouse=True)
def one_thread():
    """The tools' bf16 CPU kernels at one thread: under the suite's parallel
    workers more threads oversubscribe the cores (minutes, not seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _originals(tool):
    return [(owner, name, getattr(owner, name)) for owner, name in tool.patch_targets()]


def _restored(saved):
    return all(getattr(owner, name) is value for owner, name, value in saved)


def test_ablate_torch_step(tmp_path, capsys):
    tool = _tool("ablate_torch_step")
    saved = _originals(tool)
    out = _run(tool, TINY + ["--seconds", "60", "--iters", "1"], tmp_path, capsys)
    assert list(out["ms"]) == [name for name, _ in tool.VARIANTS]
    assert all(ms > 0 for ms in out["ms"].values()) and out["chunk"] == [64, 128, 128]
    assert _restored(saved)

    model = tool.build_model(64, 2, torch.bfloat16, torch.device("cpu"))
    rows, trunc, capacity = tool.segment_inputs(model, 60.0, torch.device("cpu"))
    assert capacity == out["capacity"] == rows[0].shape[0]
    for name, kw in tool.VARIANTS:
        _, tokens = tool.run_variant(model, rows, trunc, 1, **kw)
        assert _restored(saved), name
        if name == "full":
            full = tokens
    with torch.inference_mode():
        att, cnn = model.encoder.init_caches(128, torch.bfloat16, torch.device("cpu"))
        enc, _, _ = model.encoder.parallel_chunk(*rows, 64, 128, 128, att, cnn, trunc)
        assert torch.equal(full, model.ctc.argmax(enc))


def test_ablate_torch_train_step(tmp_path, capsys):
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step
    from chunkformer_tpu_torch.utils.params import random_params_like

    tool = _tool("ablate_torch_train_step")
    saved = _originals(tool)
    size = ["--batch", "2", "--frames", "300", "--labels", "8", "--steps", "1"]
    out = _run(tool, TINY + size, tmp_path, capsys)
    assert list(out["ms"]) == list(tool.VARIANTS) == list(out["loss"])
    assert all(ms > 0 for ms in out["ms"].values())
    assert _restored(saved)

    cfg = tool.build_cfg("full", 64, 2)
    model = random_params_like(ASRModel(cfg), seed=1)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                 {"warmup_steps": 25000})
    step = make_train_step(model, cfg, opt, sched, (64, 128, 128), autocast=torch.bfloat16,
                           grad_clip=5.0)
    batch = tool.make_batch(cfg.vocab_size, 2, 300, 8, torch.device("cpu"))
    loss = float(step(*batch, torch.Generator().manual_seed(0))["loss"])
    assert out["loss"]["full"] == loss


def test_bench_torch_endless_breakdown(tmp_path, capsys):
    from chip_smoke import scaled_large
    from chunkformer_tpu_torch import api
    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.utils.params import random_params_like

    tool = _tool("bench_torch_endless_breakdown")
    out = _run(tool, TINY + ["--seconds", "30", "--budget", "10", "--trials", "2"], tmp_path,
               capsys)
    assert len(out["trials"]) == 2 and out["frames"] == 2998
    for trial in out["trials"]:
        assert set(trial["phases_s"]) == set(tool.PHASES)
        assert trial["phases_s"]["encoder"] > 0 and trial["device_ms_per_segment"] is None
    assert out["link"]["upload_bytes"] == 2998 * 80 and out["link"]["pinned_upload_gb_s"] is None

    cfg = ChunkFormerConfig.from_dict(scaled_large(64, 2))
    model = ChunkFormerModel(cfg, random_params_like(ASRModel(cfg)).state_dict(),
                             dtype=torch.bfloat16, device="cpu")
    feats = np.random.default_rng(1).normal(size=(2998, 80)).astype(np.float32)
    saved = [api.FeatureUpload.__init__, api.FeatureUpload.wait, api.FeatureUpload.prefetch,
             type(model.model.encoder).parallel_chunk]
    tokens, _, _ = tool.walk(model, feats, 10, tool.PhaseClock())
    assert saved == [api.FeatureUpload.__init__, api.FeatureUpload.wait,
                     api.FeatureUpload.prefetch, type(model.model.encoder).parallel_chunk]
    np.testing.assert_array_equal(tokens, model.endless_encode_tokens(feats, 64, 128, 128, 10))


def test_bench_torch_pipeline_counts_equal_jax(tmp_path, capsys):
    from chunkformer_tpu.data.pipeline import Dataset
    from chunkformer_tpu.data.tokenizer import build_tokenizer

    tool = _tool("bench_torch_pipeline")
    out = _run(tool, ["--device", "cpu", "--n", "40", "--seconds", "2"], tmp_path, capsys)
    assert [v["name"] for v in out["variants"]] == [name for name, _ in tool.VARIANTS]

    jax_tool = _tool("bench_pipeline")
    root = tmp_path / "wavs"
    root.mkdir()
    lst, units = jax_tool.make_data(str(root), 40, 2.0)
    for (name, conf), got in zip(tool.VARIANTS, out["variants"]):
        ds = Dataset("raw", lst, build_tokenizer("char", {"symbol_table_path": units}), conf)
        utts = batches = 0
        for batch in ds:
            utts += batch["feats"].shape[0]
            batches += 1
        assert jax_tool.run_once(lst, units, conf)[1] == batches
        assert (got["utts"], got["batches"]) == (utts, batches), name
        assert got["utts_per_s"] > 0
