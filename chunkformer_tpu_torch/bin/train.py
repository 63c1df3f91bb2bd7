"""Training CLI (counterpart of ``chunkformer_tpu/bin/train.py``; reference
chunkformer/bin/train.py:89-214), driven by the reference YAML schema.

    python -m chunkformer_tpu_torch.bin.train --config conf.yaml \
        --train_data train.list --cv_data dev.list --model_dir exp [--device cpu]
    torchrun --nproc_per_node N -m chunkformer_tpu_torch.bin.train ... --distributed

Per epoch: train, CV, then the checkpoint ``epoch_N``. It trains in float32
on the card unless ``--device cpu``. ``--distributed`` joins the process
group torchrun describes (one process per card). ``--sharding`` places the
model on the (data, model = ``--tp_size``) mesh as ``chunkformer_tpu``'s
train CLI does: ``dp`` (DistributedDataParallel), ``fsdp`` (parameters,
gradients and Adam sharded over data), ``tp`` (attention heads and FFN
hidden units over model) or ``fsdp_tp`` (both); each data index reads its
shard of the train list, and the processes of one model group read the
same. A sharded mode outside torchrun runs as a world of one process.
Checkpoints hold full state dicts in every mode. The last log line gives
the kernels' launch counts of the run (``ops/kernels.py:launch_counts``).
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ChunkFormer training (PyTorch)")
    p.add_argument("--config", required=True, help="YAML config")
    p.add_argument("--data_type", default="raw", choices=["raw", "shard"])
    p.add_argument("--train_data", required=True)
    p.add_argument("--cv_data", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--checkpoint", default=None, help="resume tag")
    p.add_argument("--override_config", action="append", default=[],
                   help='dot-path override: "a.b.c value"')
    p.add_argument("--sharding", default="dp", choices=["dp", "fsdp", "tp", "fsdp_tp"],
                   help="dp: replicated (DDP); fsdp: sharded over data; tp: heads and FFN "
                        "over model; fsdp_tp: both")
    p.add_argument("--tp_size", type=int, default=1,
                   help="the model axis of the (data, model) mesh")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--freeze_modules", default=None,
                   help="comma list of parameter-name substrings to freeze "
                        "(e.g. 'encoder.embed,encoder.encoders')")
    p.add_argument("--enc_init", default=None, help="model_dir holding the checkpoint 'init'")
    p.add_argument("--enc_init_mods", default="encoder.",
                   help="comma-separated parameter-name regexes to copy")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (RANK, WORLD_SIZE, ... in the "
                        "environment): one process per card")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_model(cfg, seed: int, cmvn=None):
    """The model of ``cfg.model`` with weights drawn from ``seed`` and the
    global CMVN stats (mean, istd) where given."""
    import torch

    from ..models.asr import ASRModel, init_random_
    from ..models.classification import ClassificationModel
    from ..models.transducer import TransducerModel

    kind = {"transducer": TransducerModel, "classification": ClassificationModel}.get(
        cfg.model, ASRModel)
    model = init_random_(kind(cfg, cmvn is not None), torch.Generator().manual_seed(seed))
    if cmvn is not None:
        with torch.no_grad():
            model.encoder.global_cmvn.mean.copy_(torch.from_numpy(cmvn[0]))
            model.encoder.global_cmvn.istd.copy_(torch.from_numpy(cmvn[1]))
    return model


def run(argv=None):
    """The CLI's work: trains and returns the Executor (its ``timings`` and
    ``step`` are the run's)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    import yaml

    from ..api import load_cmvn_file, resolve_device
    from ..config import ChunkFormerConfig, override_config
    from ..data.pipeline import Dataset
    from ..data.tokenizer import build_tokenizer
    from ..parallel.mesh import DataParallel, Parallel, init_distributed
    from ..train.checkpoint import load_checkpoint, load_trained_modules
    from ..train.executor import Executor, pick_loss_fn
    from ..train.optim import build_optimizer, freeze_modules

    device = resolve_device(args.device)
    if args.distributed or args.sharding != "dp" or args.tp_size > 1:
        dp = init_distributed(device, args.sharding, args.tp_size, from_env=args.distributed)
        logging.info("distributed: rank %d of %d on %s, --sharding %s --tp_size %d", dp.rank,
                     dp.world, dp.device, dp.mode, dp.tp_size)
    else:
        dp = DataParallel(device=device)

    with open(args.config) as f:
        raw = yaml.safe_load(f)
    raw = override_config(raw, args.override_config)
    tokenizer = None
    if raw.get("tokenizer"):
        tokenizer = build_tokenizer(raw["tokenizer"], raw.get("tokenizer_conf", {}))
        raw["output_dim"] = tokenizer.vocab_size
    cfg = ChunkFormerConfig.from_dict(raw)

    cmvn = None
    if cfg.cmvn == "global_cmvn" and cfg.cmvn_conf.get("cmvn_file"):
        cmvn = load_cmvn_file(cfg.cmvn_conf["cmvn_file"], cfg.cmvn_conf.get("is_json_cmvn", True))

    is_classification = cfg.model == "classification"
    dataset_conf = raw.get("dataset_conf", {})
    train_ds = Dataset(args.data_type, args.train_data, tokenizer, dataset_conf,
                       partition=True, num_shards=dp.data_size, shard_id=dp.data_rank,
                       seed=args.seed, is_classification=is_classification)
    cv_conf = copy.deepcopy(dataset_conf)
    for k in ("speed_perturb", "spec_aug", "spec_sub", "spec_trim", "shuffle"):
        cv_conf[k] = False
    if "fbank_conf" in cv_conf:
        cv_conf["fbank_conf"]["dither"] = 0.0
    cv_ds = Dataset(args.data_type, args.cv_data, tokenizer, cv_conf, partition=False,
                    seed=args.seed, is_classification=is_classification)

    model = build_model(cfg, args.seed, cmvn)
    if args.enc_init:
        load_trained_modules(model, args.enc_init, "init", args.enc_init_mods.split(","))
    if args.freeze_modules:
        freeze_modules(model, args.freeze_modules.split(","))
    start_epoch = 0
    if args.checkpoint:  # one format in every mode: full state dicts
        state, opt_state, sched_state, info = load_checkpoint(args.model_dir, args.checkpoint)
        model.load_state_dict(state, strict=True)
    model.to(dp.device)
    # placed before the optimizer, which then holds the shards
    parallel = Parallel(model, cfg, pick_loss_fn(cfg), dp)
    optimizer, scheduler = build_optimizer(
        [p for p in model.parameters() if p.requires_grad], raw.get("optim", "adam"),
        raw.get("optim_conf", {"lr": 1e-3}), raw.get("scheduler", "warmuplr"),
        raw.get("scheduler_conf", {}))
    if args.checkpoint:
        if opt_state is not None:
            parallel.load_optimizer_state(optimizer, opt_state)
        if sched_state is not None:
            scheduler.load_state_dict(sched_state)
        start_epoch = info.get("epoch", 0) + 1
        logging.info("resumed from %s at step %s epoch %s", args.checkpoint,
                     info.get("step"), info.get("epoch"))

    os.makedirs(args.model_dir, exist_ok=True)
    if dp.is_main:
        with open(os.path.join(args.model_dir, "train.yaml"), "w") as f:
            yaml.safe_dump(raw, f)

    executor = Executor(cfg, model, optimizer, scheduler, args.model_dir,
                        log_interval=raw.get("log_interval", 100),
                        accum_grad=raw.get("accum_grad", 1),
                        save_interval=raw.get("save_interval"), seed=args.seed,
                        grad_clip=raw.get("grad_clip", 5.0), dp=dp, parallel=parallel)
    for epoch in range(start_epoch, raw.get("max_epoch", 100)):
        train_ds.set_epoch(epoch)
        executor.train_epoch(iter(train_ds), epoch, iter(cv_ds))
        cv_loss = executor.cv(iter(cv_ds))
        logging.info("epoch %d cv_loss %.4f", epoch, cv_loss)
        executor.save(epoch, tag=f"epoch_{epoch}", cv_loss=cv_loss)
    from ..ops.kernels import launch_counts

    logging.info("kernel launches: %s", json.dumps(launch_counts()))
    return executor


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
