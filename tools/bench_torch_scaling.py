#!/usr/bin/env python3
"""Scaling efficiency of the port's sharded masked-batch decode: audio-s/s
against process count (counterpart of ``tools/bench_scaling.py``).

    torchrun --nproc_per_node N tools/bench_torch_scaling.py [--minutes 10] [--iters 3]

Packs ``--minutes`` of random features into chunk rows at (c, L, R) =
(64, 128, 128) and decodes them with the encoder's ``parallel_chunk`` and
the CTC argmax, the rows split over the first n processes of the world
(``parallel/row_shard.py``: capacity rounded up to a multiple of n, a halo
exchange in every layer, the tokens gathered to every rank), for n = 1, 2,
4, ... up to ``--devices`` (0: the whole world). Random weights from
``utils/params.py:random_params_like`` at ChunkFormer-large width by default
(512 d, 8 heads, 17 blocks, vocabulary 6992), f32 as the JAX tool.

Each n runs once to warm up, then ``--iters`` times between two barriers
of its group, timed with CUDA events on the card (a host clock on the
CPU); a count's time is the slowest rank's. Prints one JSON line per
process count, ``{"devices", "audio_s_per_s", "scaling_efficiency"}``
(efficiency: throughput over n times the one-process throughput), then
``{"scaling": [...]}``; ``--json PATH`` writes the list with the device's
name and, on the card, its name and power limit from ``nvidia-smi``.
Needs torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT):
NCCL on the card, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C, LEFT, RIGHT = 64, 128, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=0, help="most processes (0: the world)")
    ap.add_argument("--minutes", type=float, default=10.0, help="audio per pass")
    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--num_blocks", type=int, default=17)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="write the results here (rank 0)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from chip_smoke import card_name, scaled_large
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.parallel.mesh import init_distributed
    from chunkformer_tpu_torch.parallel.row_shard import pack_for_world, split_rows
    from chunkformer_tpu_torch.utils.params import random_params_like

    dp = init_distributed(torch.device(args.device))
    dev = dp.device
    most = args.devices or dp.world
    if most > dp.world:
        raise SystemExit(f"--devices {most} > the world of {dp.world} processes")
    cfg = ChunkFormerConfig.from_dict(scaled_large(args.d_model, args.num_blocks))
    model = random_params_like(ASRModel(cfg)).to(dev).eval()
    audio_s = args.minutes * 60
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(int(audio_s * 100), 80)).astype(np.float32))

    def meta(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    results, base, n = [], None, 1
    while n <= most:
        group = dist.new_group(list(range(n)))  # every rank of the world takes part
        if dp.rank < n:
            block = split_rows(pack_for_world([feats], [len(feats)], C, n), dp.rank, n)
            xs = block.xs.to(dev)
            rows = (meta(block.chunk_idx), meta(block.offsets), meta(block.max_lens))
            att, cnn = model.encoder.init_caches(LEFT, torch.float32, dev)

            @torch.inference_mode()
            def step():
                out, _, _ = model.encoder.parallel_chunk(xs, *rows, C, LEFT, RIGHT, att, cnn, 0,
                                                         group=group)
                return model.ctc.gathered_argmax(out, group)

            step()
            dist.barrier(group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(args.iters):
                    step()
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3 / args.iters
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step()
                seconds = (time.perf_counter() - t0) / args.iters
            slowest = torch.tensor([seconds], dtype=torch.float64, device=dev)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
            tput = audio_s / float(slowest)
            base = tput if base is None else base
            results.append({"devices": n, "audio_s_per_s": tput,
                            "scaling_efficiency": tput / (base * n)})
            if dp.rank == 0:
                print(json.dumps(results[-1]), flush=True)
        dist.barrier()
        n *= 2
    if dp.rank == 0:
        print(json.dumps({"scaling": results}), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"scaling": results, "device": card_name(dev),
                           "minutes": args.minutes, "d_model": args.d_model,
                           "num_blocks": args.num_blocks, "chunk": [C, LEFT, RIGHT]}, f,
                          indent=1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
