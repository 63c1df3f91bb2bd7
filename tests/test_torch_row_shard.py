"""Masked-batch decode with the chunk rows split over processes
(``chunkformer_tpu_torch/parallel/row_shard.py``), against the JAX
package's unsharded ``encoder_parallel_chunk`` + ``ctc_argmax``
(``tests/test_sharded_inference.py`` shards the same rows under GSPMD).

- The row split for worlds 1-4, with capacity-padding rows.
- ``exchange`` on every split of a stream, its ranks run as threads of one
  process over a stand-in for ``torch.distributed``: the halo rows and the
  kept rows are slices of the global stream, bit for bit, shards shorter
  than the halo included.
- Two and four gloo processes, every case in one launch each: one long
  file, a masked batch of a long and a short file, ``trunc`` 0 and above 0,
  a row a rank (c = 8 < L = 16: the halo spans two ranks), ranks holding
  only padding rows. Each rank's gathered tokens equal JAX's on the XLA
  path and on its Pallas kernel in interpret mode; outputs and both new
  caches are within 1e-5 of both, and within 2e-6 of the port's
  ``group=None`` call on the whole batch. JAX runs in the pytest process and
  its results reach the workers in an ``.npz``, so the workers import no
  JAX. The two-process launch also runs ``tools/bench_torch_scaling.py``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from chunkformer_tpu_torch.ops.chunk import pack_chunks
from chunkformer_tpu_torch.parallel import row_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, L, R = 8, 16, 16
CONFIG = {"encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                           "num_blocks": 2, "cnn_module_kernel": 15,
                           "cnn_module_norm": "layer_norm"},
          "output_dim": 64}
# rows: 16; 14 of two files; 4 (one a rank at world 4); 2 in a capacity of 8
# (ranks of padding rows only). Capacities are multiples of 4, so worlds 2
# and 4 decode the same packed batch.
CASES = [
    {"name": "long", "lengths": [1000], "offsets": [6], "capacity": 16, "trunc": 0},
    {"name": "long-trunc", "lengths": [1000], "offsets": [0], "capacity": 16,
     "trunc": 6 * C + 5},
    {"name": "two-files", "lengths": [700, 150], "offsets": [0, 3], "capacity": 16,
     "trunc": 9 * C},
    {"name": "row-a-rank", "lengths": [250], "offsets": [2], "capacity": 4,
     "trunc": 2 * C + 3},
    {"name": "padding-ranks", "lengths": [100], "offsets": [0], "capacity": 8, "trunc": 5},
]


def case_inputs(i, case):
    """The case's features, its caches [2, L, 4, 32] / [2, 64, 7] and the packed batch."""
    rng = np.random.default_rng(100 + i)
    feats = [rng.normal(size=(t, 80)).astype(np.float32) for t in case["lengths"]]
    att = rng.normal(size=(2, L, 4, 32)).astype(np.float32)
    cnn = rng.normal(size=(2, 64, 7)).astype(np.float32)
    packed = pack_chunks([torch.from_numpy(f) for f in feats], case["lengths"], C,
                         offsets=case["offsets"], capacity=case["capacity"])
    return feats, att, cnn, packed


# ---------------------------------------------------------------- no processes


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_row_split(world):
    """Capacity is the rows (or the asked capacity) rounded up to the world;
    the blocks are contiguous, equal, in rank order, and cover the batch."""
    rng = np.random.default_rng(world)
    lengths = [700, 150, 90]
    feats = [torch.from_numpy(rng.normal(size=(t, 80)).astype(np.float32)) for t in lengths]
    rows = pack_chunks(feats, lengths, C).xs.shape[0]
    for capacity in (None, rows + 5):
        packed = row_shard.pack_for_world(feats, lengths, C, world, offsets=[1, 2, 3],
                                          capacity=capacity)
        cap = packed.xs.shape[0]
        want = max(rows, capacity or 0)
        assert cap % world == 0 and want <= cap < want + world
        assert row_shard.world_capacity(want, world) == cap
        blocks = [row_shard.split_rows(packed, r, world) for r in range(world)]
        assert [b.first_row for b in blocks] == [r * cap // world for r in range(world)]
        assert torch.equal(torch.cat([b.xs for b in blocks]), packed.xs)
        for name in ("chunk_idx", "offsets", "max_lens"):
            np.testing.assert_array_equal(np.concatenate([getattr(b, name) for b in blocks]),
                                          getattr(packed, name))
        assert not packed.valid[rows:].any() and not packed.xs[rows:].any()
    if world > 1:
        with pytest.raises(ValueError):
            row_shard.split_rows(pack_chunks(feats, lengths, C, capacity=4 * world + 1),
                                 0, world)


class FakeDist:
    """The three calls of ``torch.distributed`` that ``row_shard`` makes,
    for ranks run as threads of one process; a rank's group is its rank."""

    def __init__(self, world):
        self.world = world
        self.slots = [None] * world
        self.barrier = threading.Barrier(world, timeout=30)

    def get_rank(self, group):
        return group

    def get_world_size(self, group):
        return self.world

    def all_gather(self, out, t, group=None):
        self.slots[group] = t.clone()
        self.barrier.wait()
        for o, s in zip(out, self.slots):
            o.copy_(s)
        self.barrier.wait()


def run_ranks(world, fn):
    """fn(rank) on each rank's thread; the results in rank order."""
    results, errors = [None] * world, []

    def target(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 (re-raised in the caller)
            errors.append(e)
            fake.barrier.abort()

    fake = row_shard.dist
    threads = [threading.Thread(target=target, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_exchange_equals_slices_of_the_global_stream(world, monkeypatch):
    """Halo and kept rows bit for bit, for shards of 1-40 rows against halos
    of 0-16 rows (a halo over several ranks where a shard is shorter), kept
    spans in the fill, across shard boundaries and in the zero tail."""
    monkeypatch.setattr(row_shard, "dist", FakeDist(world))
    rng = np.random.default_rng(world)
    for m in (1, 3, 8, 16, 40):
        for left, right in ((0, 0), (16, 16), (16, 7), (7, 16), (0, 16)):
            g = torch.from_numpy(rng.normal(size=(world * m, 3, 2)).astype(np.float32))
            fill = torch.from_numpy(rng.normal(size=(left, 3, 2)).astype(np.float32))
            full = torch.cat([fill, g, torch.zeros(right, 3, 2)])
            total = full.shape[0]
            for start, count in {(0, left), (left - 2, 5), (total // 2, left),
                                 (total - 4, 4), (left + m - 1, 2 * m + 1)}:
                start = min(max(start, 0), total)
                count = min(count, total - start)
                got = run_ranks(world, lambda r: row_shard.exchange(
                    g[r * m:(r + 1) * m], fill, right, r, (start, count)))
                for r, (stream, kept) in enumerate(got):
                    assert torch.equal(stream, full[r * m:r * m + left + m + right]), (m, r)
                    assert torch.equal(kept, full[start:start + count]), (m, r, start)
    with pytest.raises(ValueError):
        run_ranks(world, lambda r: row_shard.exchange(g[:m], fill, right, r,
                                                      (total - 1, 2)))


# ---------------------------------------------------------------- processes


def worker(data_dir, scaling_json=None):
    """One rank, with torchrun's environment set by the caller: every case
    in turn, then (when ``scaling_json`` is given) the scaling tool."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    dp = init_distributed(torch.device("cpu"))
    group = dist.group.WORLD
    model = ASRModel(ChunkFormerConfig.from_dict(CONFIG))
    model.load_state_dict(torch.load(os.path.join(data_dir, "model.pt")), strict=True)
    model.eval()
    want = np.load(os.path.join(data_dir, "jax.npz"))
    t = torch.from_numpy
    for i, case in enumerate(CASES):
        name = case["name"]
        feats, att, cnn, _ = case_inputs(i, case)
        packed = row_shard.pack_for_world([t(f) for f in feats], case["lengths"], C,
                                          dp.world, case["offsets"], case["capacity"])
        block = row_shard.split_rows(packed, dp.rank, dp.world)
        rows = slice(block.first_row, block.first_row + block.xs.shape[0])
        with torch.no_grad():
            full = model.encoder.parallel_chunk(
                packed.xs, t(packed.chunk_idx), t(packed.offsets), t(packed.max_lens), C, L, R,
                t(att), t(cnn), case["trunc"])
            out, new_att, new_cnn = model.encoder.parallel_chunk(
                block.xs, t(block.chunk_idx), t(block.offsets), t(block.max_lens), C, L, R,
                t(att), t(cnn), case["trunc"], group=group)
            tokens = model.ctc.gathered_argmax(out, group).numpy()
        # against the port's single-process call, padding rows included; not
        # bitwise: the CPU's f32 GEMMs round a row differently at another row
        # count (up to 1.43e-6 here), while the exchange itself is exact
        # (test_exchange_equals_slices_of_the_global_stream)
        for got, ref in ((out, full[0][rows]), (new_att, full[1]), (new_cnn, full[2])):
            torch.testing.assert_close(got, ref, atol=2e-6, rtol=0, msg=lambda m: f"{name}: {m}")
        valid = packed.valid[rows]
        for path in ("xla", "pallas"):
            # each file's frames, trimmed by its output length
            ref_tokens = want[f"{name}/{path}/tokens"].reshape(-1)
            first = 0
            for n_chunks, out_len in zip(packed.n_chunks, packed.out_lens):
                sl = slice(first * C, first * C + int(out_len))
                np.testing.assert_array_equal(tokens.reshape(-1)[sl], ref_tokens[sl],
                                              err_msg=f"{name} {path}")
                first += n_chunks
            np.testing.assert_allclose(out.numpy()[valid], want[f"{name}/{path}/out"][rows][valid],
                                       atol=1e-5, rtol=1e-5, err_msg=f"{name} {path}")
            for key, got in (("att", new_att), ("cnn", new_cnn)):
                np.testing.assert_allclose(got.numpy(), want[f"{name}/{path}/{key}"], atol=1e-5,
                                           rtol=1e-5, err_msg=f"{name} {path} {key}")
        print(f"rank {dp.rank}/{dp.world} {name}: rows {rows.start}-{rows.stop - 1}, "
              f"{int(valid.sum())} valid", flush=True)
    if scaling_json is not None:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "bench_torch_scaling", os.path.join(REPO, "tools", "bench_torch_scaling.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        tool.main(["--device", "cpu", "--devices", str(dp.world), "--d_model", "64",
                   "--num_blocks", "2", "--minutes", "0.1", "--iters", "1",
                   "--json", scaling_json])
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX model's weights as a port state dict and every case's JAX
    results (XLA path, Pallas in interpret mode) on disk."""
    import jax
    import jax.numpy as jnp

    from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
    from chunkformer_tpu.models.asr import ctc_argmax, init_asr_model
    from chunkformer_tpu.nn.encoder import encoder_parallel_chunk
    from chunkformer_tpu.ops import chunk as jchunk
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.convert import state_dict_from_jax_params

    root = tmp_path_factory.mktemp("row_shard")
    jcfg = JaxConfig.from_dict(CONFIG)
    rng = np.random.default_rng(0)
    cmvn = (rng.normal(size=80).astype(np.float32), rng.uniform(0.5, 1.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(3), jcfg, cmvn))
    torch.save(state_dict_from_jax_params(params, ChunkFormerConfig.from_dict(CONFIG)),
               str(root / "model.pt"))
    arrays = {}
    for i, case in enumerate(CASES):
        feats, att, cnn, packed = case_inputs(i, case)
        assert case["capacity"] % 4 == 0 and case["capacity"] >= sum(packed.n_chunks)
        jp = jchunk.pack_chunks(feats, case["lengths"], C, offsets=case["offsets"],
                                capacity=case["capacity"])
        args = [jnp.asarray(a) for a in (jp.xs, jp.chunk_idx, jp.offsets, jp.max_lens)]
        for path, kw in (("xla", {}), ("pallas", {"use_pallas": True, "pallas_interpret": True})):
            out, new_att, new_cnn = encoder_parallel_chunk(
                params["encoder"], jcfg.encoder_conf, *args, C, L, R, jnp.asarray(att),
                jnp.asarray(cnn), case["trunc"], **kw)
            for key, value in (("out", out), ("att", new_att), ("cnn", new_cnn),
                               ("tokens", ctc_argmax(params["ctc"], out))):
                arrays[f"{case['name']}/{path}/{key}"] = np.asarray(value)
    np.savez(str(root / "jax.npz"), **arrays)
    return root


def test_sharded_decode_two_processes(jax_results):
    """Every case on 2 gloo processes, then the scaling tool at
    ``--devices 2``: one JSON line per process count and the summary."""
    from tests.test_torch_sharding import _spawn

    out = jax_results / "scaling.json"
    _spawn(2, f"from tests.test_torch_row_shard import worker; "
              f"worker({str(jax_results)!r}, {str(out)!r})")
    with open(out) as f:
        result = json.load(f)
    runs = result["scaling"]
    assert [r["devices"] for r in runs] == [1, 2]
    assert all(r["audio_s_per_s"] > 0 and r["scaling_efficiency"] > 0 for r in runs)
    assert runs[0]["scaling_efficiency"] == 1.0 and result["device"] == "cpu"


def test_sharded_decode_four_processes(jax_results):
    """Every case on 4 gloo processes (a row a rank; three ranks of padding rows)."""
    from tests.test_torch_sharding import _spawn

    _spawn(4, f"from tests.test_torch_row_shard import worker; worker({str(jax_results)!r})")
