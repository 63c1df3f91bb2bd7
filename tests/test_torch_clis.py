"""The port's CLIs against the JAX package's, in process on the CPU.

Each CLI's ``main(argv)`` runs with ``--device cpu`` (and f32) beside the
JAX CLI's ``main(argv)`` on the same hybrid CTC/AED export and test list;
their result files, and the decode CLI's standard output, must be
identical. No subprocess is spawned.
"""

import os
import string

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from chunkformer_tpu.bin import alignment as jax_alignment
from chunkformer_tpu.bin import decode as jax_decode
from chunkformer_tpu.bin import recognize as jax_recognize
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu_torch.bin import alignment, decode, recognize

from .test_torch_api import _speechlike
from .test_torch_search import HYBRID

SYMBOLS = string.ascii_lowercase + string.ascii_uppercase + string.digits + "▁"
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "ctc_prefix_beam_search_batched",
         "attention", "attention_rescoring"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A hybrid export with a character vocabulary, four WAVs of 1.3-2.9 s,
    a test list with references, and a hotword file."""
    root = tmp_path_factory.mktemp("torch_clis")
    rng = np.random.default_rng(21)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(21),
                                                     JaxConfig.from_dict(HYBRID), cmvn))
    table = {"<blank>": 0, **{ch: i + 1 for i, ch in enumerate(SYMBOLS)}}
    model_dir = export_model_dir(str(root / "export"), HYBRID, params, table)
    rows = []
    for i, seconds in enumerate((2.9, 1.3, 2.2, 1.7)):
        path = str(root / f"u{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        rows.append(f"utt{i}\t{path}\t{'abc def'[:3 + i]} g{i}")
    test_list = root / "test.list"
    test_list.write_text("\n".join(rows) + "\n", encoding="utf-8")
    hotwords = root / "hotwords.txt"
    hotwords.write_text("ab\nQx\n7\n", encoding="utf-8")
    return model_dir, str(test_list), str(hotwords), root


def _files(d):
    return {name: open(os.path.join(d, name), encoding="utf-8").read()
            for name in sorted(os.listdir(d))}


ZERO = ["--chunk_size", "0", "--left_context_size", "0", "--right_context_size", "0"]


@pytest.mark.parametrize("chunk", [["--chunk_size", "8", "--left_context_size", "16",
                                    "--right_context_size", "16"], []])
def test_recognize_writes_the_jax_result_files(setup, chunk):
    """All five CTC/AED modes, beam 4, ctc_weight 0.3, reverse_weight 0.3,
    batch 3 (two batches, padded); at (c, L, R) = (8, 16, 16) and at the
    CLI's default full context (-1, -1, -1), which the JAX CLI runs only as
    (0, 0, 0): its encode raises on contexts of -1."""
    model_dir, test_list, _, root = setup
    tag = "chunk" if chunk else "full"
    common = ["--model_checkpoint", model_dir, "--test_data", test_list, "--modes", *MODES,
              "--beam_size", "4", "--batch_size", "3", "--reverse_weight", "0.3"]
    want_dir, got_dir = str(root / f"jax_rec_{tag}"), str(root / f"torch_rec_{tag}")
    assert jax_recognize.main([*common, *(chunk or ZERO), "--result_dir", want_dir]) == 0
    assert recognize.main([*common, *chunk, "--result_dir", got_dir, "--device", "cpu",
                           "--dtype", "fp32"]) == 0
    want, got = _files(want_dir), _files(got_dir)
    assert sorted(want) == sorted(f"{m}.{e}" for m in MODES for e in ("txt", "wer"))
    assert got == want
    assert all(len(text.splitlines()) == 4 for name, text in want.items()
               if name.endswith(".txt"))


def test_recognize_context_list_matches_jax(setup):
    """The prefix beam with a hotword graph (``--context_list``)."""
    model_dir, test_list, hotwords, root = setup
    common = ["--model_checkpoint", model_dir, "--test_data", test_list, "--modes",
              "ctc_prefix_beam_search", "--beam_size", "4",
              "--context_list", hotwords, "--context_score", "3.0", *ZERO]
    want_dir, got_dir = str(root / "jax_ctx"), str(root / "torch_ctx")
    assert jax_recognize.main([*common, "--result_dir", want_dir]) == 0
    assert recognize.main([*common, "--result_dir", got_dir, "--device", "cpu"]) == 0
    assert _files(got_dir) == _files(want_dir)


@pytest.mark.parametrize("argv,msg", [
    # the rnnt modes are ported (A18); this CTC/AED export cannot run them
    pytest.param(["--modes", "rnnt_greedy_search"], "need a transducer export", id="argv0-A18"),
    # streaming is ported (A15); it refuses the full-context default chunk
    pytest.param(["--simulate_streaming"], "requires --chunk_size > 0", id="argv1-A15")])
def test_recognize_refuses_what_is_not_ported(setup, argv, msg):
    model_dir, test_list, _, root = setup
    with pytest.raises(SystemExit, match=msg):
        recognize.main(["--model_checkpoint", model_dir, "--test_data", test_list,
                        "--result_dir", str(root / "refused"), "--device", "cpu", *argv])


def test_alignment_writes_the_jax_textgrids(setup):
    model_dir, test_list, _, root = setup
    want_dir, got_dir = str(root / "jax_align"), str(root / "torch_align")
    argv = ["--model_checkpoint", model_dir, "--input_file", test_list]
    assert jax_alignment.main([*argv, "--result_dir", want_dir]) == 0
    assert alignment.main([*argv, "--result_dir", got_dir, "--device", "cpu"]) == 0
    want = _files(want_dir)
    assert len(want) == 4 and _files(got_dir) == want


@pytest.mark.parametrize("source", ["--audio_file", "--audio_list"])
def test_decode_prints_the_jax_lines(setup, source, capsys):
    """Long-form decode of one file and masked-batch decode of the list
    (with its WER line), f32, c = 8, L = R = 16."""
    model_dir, test_list, _, root = setup
    arg = str(root / "u0.wav")
    if source == "--audio_list":   # the decode CLI reads a TSV with a header
        header = root / "decode.tsv"
        header.write_text("key\twav\ttxt\n" + open(test_list, encoding="utf-8").read(),
                          encoding="utf-8")
        arg = str(header)
    argv = ["--model_checkpoint", model_dir, source, arg, "--dtype", "fp32",
            "--chunk_size", "8", "--left_context_size", "16", "--right_context_size", "16",
            "--total_batch_duration", "3"]
    assert jax_decode.main(argv) == 0
    want = capsys.readouterr().out
    assert decode.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(want.splitlines()) >= 2
