"""Training executor: epoch and step loops, CV, logging, checkpoints
(counterpart of ``chunkformer_tpu/train/executor.py``; reference
chunkformer/utils/executor.py:36-190, utils/train_utils.py).

One train step per batch through ``make_train_step``, cached per (chunk, L,
R) drawn with ``random.Random(seed)`` in the JAX package's order (reference
encoder.py:198-218). Dropout draws from a ``torch.Generator`` seeded from
the seed (and the rank), so its bits are not the JAX package's rbg keys.
Under ``torchrun`` the model is placed for the sharding mode
(``parallel/mesh.py``: DDP, FSDP, tensor parallelism or both); metrics are
averaged over the processes, every process joins the gathering of a
checkpoint's full state dicts, and only rank 0 writes them and the
metrics.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import ChunkFormerConfig
from ..parallel.mesh import DataParallel, Parallel, all_reduce_mean
from .checkpoint import save_checkpoint
from .losses import asr_model_loss, transducer_model_loss
from .train_step import make_eval_step, make_train_step


def pick_loss_fn(cfg: ChunkFormerConfig):
    """The loss of the model kind, all with the signature (model, cfg, feats,
    feats_lens, targets, target_lens, chunk, L, R, train, generator, step);
    a classification model's targets are the {task: labels} dict."""
    if cfg.model == "transducer":
        return transducer_model_loss
    if cfg.model == "classification":
        from ..models.classification import classification_loss

        return classification_loss
    return asr_model_loss


class MetricsWriter:
    """JSONL metrics log, one line per logged step (the reference's
    tensorboard writer, train_utils.py:582-588,788-894); rank 0 only."""

    def __init__(self, path: Optional[str], is_main: bool = True):
        self.f = open(path, "a") if path and is_main else None

    def log(self, step: int, scope: str, metrics: Dict[str, float]):
        if self.f is None:
            return
        self.f.write(json.dumps({"step": step, "scope": scope, **metrics}) + "\n")
        self.f.flush()


class Executor:
    """Trains ``model`` in place, in its parameters' dtype, with
    ``optimizer`` and ``scheduler`` (from ``optim.build_optimizer``); the
    scheduler's count is the step. ``parallel`` is the model's placement
    where the caller sharded it before building the optimizer; by default
    the Executor places it for ``dp`` (DDP where a process group exists).

    The micro-batch contract under data parallelism: the train step cuts a
    process's batch into accum_grad micro-batches along its first axis,
    while the JAX step cuts the global batch into micro-batches and then
    shards each over the data axis. Statistics taken over the data group
    (batch norm, the length-normalized loss, ``acc_att``) match the JAX
    step's only where process p's k-th micro-batch is p's share of the
    global k-th micro-batch: of a global batch of B rows, p holds rows
    k * B / A + p * B / (A * P) onward, B / (A * P) of them, for k = 0 ..
    A - 1 in that order (A = accum_grad, P = the data axis's size)."""

    def __init__(self, cfg: ChunkFormerConfig, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler, model_dir: str,
                 log_interval: int = 100, accum_grad: int = 1,
                 save_interval: Optional[int] = None, seed: int = 777,
                 grad_clip: float = 5.0, dp: Optional[DataParallel] = None,
                 parallel: Optional[Parallel] = None):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.model_dir = model_dir
        self.log_interval = log_interval
        self.accum_grad = accum_grad
        self.save_interval = save_interval
        self.grad_clip = grad_clip
        self.dp = dp or DataParallel(device=next(model.parameters()).device)
        self.device = self.dp.device
        self.rng = random.Random(seed)
        # the processes of one model group draw the same dropout masks
        self.generator = torch.Generator().manual_seed(seed + self.dp.data_rank)
        self.loss_fn = pick_loss_fn(cfg)
        self.parallel = parallel or Parallel(model, cfg, self.loss_fn, self.dp)
        self._step_cache: Dict[Tuple[int, int, int], Any] = {}
        self._eval_step = None
        # every train step's (host data seconds, step seconds, feature frames);
        # a step's seconds include its wait for the card on logged steps only
        self.timings: List[Tuple[float, float, int]] = []
        os.makedirs(model_dir, exist_ok=True)
        self.metrics = MetricsWriter(os.path.join(model_dir, "metrics.jsonl"), self.dp.is_main)

    @property
    def step(self) -> int:
        return int(self.scheduler.last_epoch)

    # ------------------------------------------------------- batch -> device

    def _batch_arrays(self, batch: Dict):
        """(feats, feats_lens, targets, target_lens) of a collated batch; for
        classification the targets are {task: labels} and target_lens zeros."""
        if self.cfg.model == "classification":
            targets = {k[len("label_"):]: np.asarray(batch[k])
                       for k in batch if k.startswith("label_")}
            target_lens = np.zeros(np.asarray(batch["feats"]).shape[0], np.int32)
        else:
            targets = np.asarray(batch["target"])
            target_lens = np.asarray(batch["target_lengths"])
        return (np.asarray(batch["feats"]), np.asarray(batch["feats_lengths"]),
                targets, target_lens)

    def _pad_batch_dim(self, arrays):
        """Pad this process's batch axis to a multiple of accum_grad by
        repeating the final sample, so that its micro-batches are equal. Each
        process holds only its own batch (one card each), so the JAX
        package's multiple of the data axis x accum_grad is accum_grad here;
        the processes' batches may differ in size, and every process runs
        the same number of micro-batches, so the reference's uneven-data
        join (train_utils.py:636-664) is not needed."""
        multiple = self.accum_grad
        pad = (-arrays[0].shape[0]) % multiple
        if pad == 0:
            return arrays

        def rep(x):
            if isinstance(x, dict):
                return {k: rep(v) for k, v in x.items()}
            x = np.asarray(x)
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

        return tuple(rep(a) for a in arrays)

    def place_batch(self, arrays):
        """Padded host arrays -> tensors on the executor's device (through
        pinned host memory to a card)."""
        arrays = self._pad_batch_dim(arrays)
        cuda = self.device.type == "cuda"

        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory().to(self.device, non_blocking=True) if cuda else t

        return tuple(put(a) for a in arrays)

    # ------------------------------------------------------------ loops

    def _get_train_step(self, chunk_cfg):
        if chunk_cfg not in self._step_cache:
            par = self.parallel
            self._step_cache[chunk_cfg] = make_train_step(
                self.model, self.cfg, self.optimizer, self.scheduler, chunk_cfg,
                self.accum_grad, grad_clip=self.grad_clip, loss_fn=par.loss_fn,
                no_sync=par.no_sync, reduce_grads=par.reduce_grads, grad_norm=par.grad_norm)
        return self._step_cache[chunk_cfg]

    def _sample_chunk_cfg(self):
        from ..nn.encoder import limited_context_selection

        return limited_context_selection(self.cfg.encoder_conf, self.rng)

    def train_epoch(self, dataset: Iterable[Dict], epoch: int,
                    cv_dataset: Optional[Iterable[Dict]] = None) -> None:
        t0 = time.time()
        n_seen = 0
        it = iter(dataset)
        while True:
            t_data = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            chunk_cfg = self._sample_chunk_cfg()
            step_fn = self._get_train_step(chunk_cfg)
            arrays = self.place_batch(self._batch_arrays(batch))
            t_step = time.perf_counter()
            metrics = step_fn(*arrays, generator=self.generator)
            n_seen += batch["feats"].shape[0]
            step = self.step
            if step % self.log_interval == 0:
                metrics.pop("step", None)
                # acc_att is a ratio over the data group's tokens already
                acc = metrics.pop("acc_att", None)
                m = {k: float(v) for k, v in all_reduce_mean(metrics, self.dp).items()}
                if acc is not None:
                    m["acc_att"] = float(acc)
                rate = n_seen / max(time.time() - t0, 1e-9)
                logging.info(
                    "epoch %d step %d chunk=%s loss %.4f (%s) %.1f utts/s",
                    epoch, step, chunk_cfg, m.get("loss", float("nan")),
                    " ".join(f"{k}={v:.3f}" for k, v in m.items() if k != "loss"), rate)
                self.metrics.log(step, "train", {**m, "utts_per_s": rate, "epoch": epoch})
            self.timings.append((t_step - t_data, time.perf_counter() - t_step,
                                 int(np.asarray(batch["feats_lengths"]).sum())))
            if self.save_interval and step % self.save_interval == 0 and step > 0:
                cv_loss = self.cv(cv_dataset) if cv_dataset is not None else None
                self.save(epoch, tag=f"step_{step}", cv_loss=cv_loss)

    def cv(self, dataset: Iterable[Dict]) -> float:
        """Cross-validation loss, utterance-weighted over the batches
        (reference executor.py:132-190), at full context without dropout."""
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.model, self.cfg, self.parallel.eval_loss_fn)
        total, count = 0.0, 0
        for batch in dataset:
            metrics = self._eval_step(*self.place_batch(self._batch_arrays(batch)))
            b = batch["feats"].shape[0]
            total += float(metrics["loss"]) * b
            count += b
        return total / max(count, 1)

    def save(self, epoch: int, tag: str, cv_loss: Optional[float] = None) -> None:
        if not (self.dp.is_main or self.parallel.sharded):
            return
        model_state = self.parallel.full_state_dict()
        optimizer_state = self.parallel.full_optimizer_state(self.optimizer)
        if not self.dp.is_main:
            return
        info = {"epoch": epoch, "step": self.step,
                "save_time": time.strftime("%d/%m/%Y %H:%M:%S")}
        if cv_loss is not None:
            info["cv_loss"] = float(cv_loss)
        save_checkpoint(self.model_dir, tag, model_state, optimizer_state,
                        self.scheduler.state_dict(), info)
        logging.info("saved checkpoint %s (cv_loss=%s)", tag, cv_loss)
