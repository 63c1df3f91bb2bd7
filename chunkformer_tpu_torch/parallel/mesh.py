"""Training across processes: the ``dp``, ``fsdp``, ``tp`` and ``fsdp_tp``
modes of ``chunkformer_tpu/parallel/mesh.py`` (reference
chunkformer/utils/train_utils.py:254-489).

The JAX package lays a (data, model) mesh over its devices and lets GSPMD
place the parameters; sharding changes placement, never the result. The
port runs one process per card (``torchrun``) on the same mesh,
``init_device_mesh`` of ("data", "model") with model = ``tp_size``: a
process trains on the share of the data list of its data index, and the
processes of one model group see the same batches.

- ``dp``: ``DistributedDataParallel`` over the loss, averaging the gradients
  over ``data`` once an update (the micro-batches before the last run under
  ``no_sync``). DDP's mean over processes equals the JAX package's mean over
  the global batch only when every process's batch has the same size, as
  with static batches. The Executor pads each process's own batch to a
  multiple of accum_grad, which makes its micro-batches equal but not the
  processes' batches: with dynamic batching a process's mean weighs the
  same whatever its batch size.
- ``fsdp``: ``torch.distributed.fsdp.fully_shard`` over ``data`` on each
  encoder layer (its ``forward_train``), each decoder layer and the root
  (the loss function as a module): parameters, gradients and Adam's moments
  are sharded over ``data``; the gradients are averaged by the
  reduce-scatter, once an update (earlier micro-batches under
  ``set_requires_gradient_sync(False)``).
- ``tp``: ``parallel/tensor_parallel.py`` over ``model`` on the attentions
  and feed-forward blocks (``_TP_RULES``), the gradients averaged over
  ``data`` once an update.
- ``fsdp_tp``: tensor parallelism first, then ``fully_shard`` over ``data``.

Where the data axis is above 1 the model learns its data group
(``parallel/data_group.py``): train-mode batch-norm statistics, the
length-normalized attention loss's token count and the attention accuracy
are taken over the group, as GSPMD takes them over the global batch. The
global-norm clip counts every gradient element once whatever its
placement (``Parallel.grad_norm``). Checkpoints keep one format in every
mode: the full state dicts of the model and of Adam, gathered on every
process and written by rank 0 (``Parallel.full_state_dict``,
``full_optimizer_state``), so a ``dp`` checkpoint resumes under
``fsdp_tp`` and the other way round (``load_optimizer_state`` cuts Adam's
moments to each process's shards).
"""

from __future__ import annotations

import contextlib
import os
import socket
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .data_group import set_data_group
from .tensor_parallel import TPShard, apply_tensor_parallel

SHARDING_MODES = ("dp", "fsdp", "tp", "fsdp_tp")


@dataclass
class DataParallel:
    """The process group as the trainer sees it: rank and world, the
    sharding mode, and the (data, model) mesh where one is built."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    mode: str = "dp"
    tp_size: int = 1
    mesh: Optional[object] = None  # torch.distributed DeviceMesh ("data", "model")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_rank(self) -> int:
        """The process's index on the data axis: its share of the data."""
        return self.rank // self.tp_size

    @property
    def data_size(self) -> int:
        return self.world // self.tp_size


def check_sharding(mode: str, tp_size: int = 1, world: int = 1) -> None:
    """Refuse an unknown mode and a ``tp_size`` that does not divide the world."""
    if mode not in SHARDING_MODES:
        raise ValueError(f"unknown sharding mode {mode}")
    if tp_size < 1 or world % tp_size:
        raise ValueError(f"--tp_size {tp_size} does not divide the world of {world} processes")


def make_mesh(device: torch.device, data: int = -1, model: int = 1):
    """The ("data", "model") device mesh over the world; data = -1 takes the
    processes the model axis leaves."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if data == -1:
        data = world // max(model, 1)
    if model < 1 or data * model != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover {world} processes")
    return init_device_mesh(device.type, (data, model), mesh_dim_names=("data", "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device: torch.device, mode: str = "dp", tp_size: int = 1,
                     from_env: bool = True) -> DataParallel:
    """Join the process group that ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the card
    (cuda:LOCAL_RANK), gloo on the CPU. With ``from_env`` False and no
    torchrun environment the process forms a world of one on a free local
    port (a sharded mode outside torchrun). Every mode but ``dp`` at
    ``tp_size`` 1 builds the (data, model) mesh."""
    if from_env or "WORLD_SIZE" in os.environ:
        for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if name not in os.environ:
                raise RuntimeError(f"--distributed needs {name} in the environment "
                                   "(torchrun sets it)")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world, init = 0, 1, f"tcp://localhost:{_free_port()}"
    check_sharding(mode, tp_size, world)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init, rank=rank, world_size=world)
    mesh = None
    if mode != "dp" or tp_size > 1:
        mesh = make_mesh(device, -1, tp_size)
    return DataParallel(rank, world, device, mode, tp_size, mesh)


class _LossForward(torch.nn.Module):
    """The model under DDP, or FSDP's root: forward(...) is the loss
    function's call, so their hooks see every forward and backward."""

    def __init__(self, model: torch.nn.Module, cfg, loss_fn: Callable[..., Dict]):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.loss_fn = loss_fn

    def forward(self, *args, **kwargs):
        return self.loss_fn(self.model, self.cfg, *args, **kwargs)


def loss_leaves_unused(model: torch.nn.Module, cfg) -> bool:
    """Whether the training loss can leave a parameter of ``model`` without
    a gradient, so that DDP must search the autograd graph for such
    parameters after every forward (``find_unused_parameters``). Exact for
    the hybrid CTC/AED loss: the CTC head at ctc_weight 0, the decoder at
    ctc_weight 1, the right decoder at reverse_weight 0. The transducer and
    classification losses are taken to leave some (their optional heads and
    branches)."""
    if cfg.model != "asr_model":
        return True
    mc = cfg.model_conf
    dec = model.decoder
    return mc.ctc_weight <= 0.0 or (dec is not None and (
        mc.ctc_weight >= 1.0 or (dec.right_decoder is not None and mc.reverse_weight <= 0.0)))


class Parallel:
    """``model`` placed for the mode of ``dp``, and what the train step
    needs from the placement: the loss functions to call (the model through
    DDP or FSDP's root), the context of the micro-batches whose gradients
    are not yet averaged, the gradients' averaging and global norm, and the
    full state dicts of checkpoints. Where the world is one process in
    ``dp`` (no process group) it leaves the model as it is."""

    def __init__(self, model: torch.nn.Module, cfg, loss_fn: Callable[..., Dict],
                 dp: DataParallel):
        self.model, self.dp = model, dp
        self.loss_fn = self.eval_loss_fn = loss_fn
        self.no_sync: Callable[[], ContextManager] = contextlib.nullcontext
        self.tp_split: Dict[str, int] = {}
        self._tp = self._data_group = None
        self._fsdp = False
        if dp.mesh is None:
            if dp.world > 1 or dist.is_initialized():
                self._ddp(cfg, None)
                set_data_group(model, dist.group.WORLD if dp.world > 1 else None)
            return
        self._data_group = dp.mesh.get_group("data")
        set_data_group(model, self._data_group if dp.data_size > 1 else None)
        if dp.mode in ("tp", "fsdp_tp"):
            self._tp = TPShard(dp.mesh.get_group("model"), dp.rank % dp.tp_size, dp.tp_size)
            self.tp_split = apply_tensor_parallel(model, self._tp)
        if dp.mode in ("fsdp", "fsdp_tp"):
            self._fully_shard(cfg)
        elif dp.mode == "dp":
            self._ddp(cfg, self._data_group)

    # ------------------------------------------------------------ placement

    def _ddp(self, cfg, group) -> None:
        dev = self.dp.device
        wrapped = torch.nn.parallel.DistributedDataParallel(
            _LossForward(self.model, cfg, self.loss_fn),
            device_ids=[dev.index] if dev.type == "cuda" else None, process_group=group,
            find_unused_parameters=loss_leaves_unused(self.model, cfg))
        self.loss_fn = lambda _model, _cfg, *args, **kwargs: wrapped(*args, **kwargs)
        self.no_sync = wrapped.no_sync

    def _fully_shard(self, cfg) -> None:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

        self._fsdp = True
        mesh = self.dp.mesh["data"]
        model = self.model
        for layer in model.encoder.encoders:
            fully_shard(layer, mesh=mesh)
            register_fsdp_forward_method(layer, "forward_train")
        decoder = getattr(model, "decoder", None)
        for side in (getattr(decoder, "left_decoder", None),
                     getattr(decoder, "right_decoder", None)):
            for layer in (side.decoders if side is not None else ()):
                fully_shard(layer, mesh=mesh)
        root = fully_shard(_LossForward(model, cfg, self.loss_fn), mesh=mesh)
        self.loss_fn = self.eval_loss_fn = lambda _model, _cfg, *args, **kwargs: root(
            *args, **kwargs)

        @contextlib.contextmanager
        def no_sync():
            root.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                root.set_requires_gradient_sync(True)

        self.no_sync = no_sync

    # ------------------------------------------------------------ gradients

    def reduce_grads(self, params: List[torch.Tensor]) -> None:
        """Average the gradients over ``data`` where neither DDP nor FSDP
        does (``tp``), once an update."""
        if self.dp.mode != "tp" or self.dp.data_size <= 1:
            return
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self._data_group)
        flat /= self.dp.data_size
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def grad_norm(self, params: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """The global norm of the parameters' gradients with every element
        counted once: a shard of ``data`` (FSDP) or of ``model`` (tensor
        parallelism) summed over its group, a replica counted once. None
        where nothing is sharded (the train step's own norm)."""
        if self._tp is None and not self._fsdp:
            return None
        split = {id(p) for n, p in self.model.named_parameters() if n in self.tp_split}

        def square(grads):
            if not grads:
                return torch.zeros((), device=self.dp.device)
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).square()

        sq_split = square([_local(p.grad) for p in params if id(p) in split]).float()
        sq_rest = square([_local(p.grad) for p in params if id(p) not in split]).float()
        if self._fsdp:
            both = torch.stack([sq_split, sq_rest])
            dist.all_reduce(both, group=self._data_group)
            sq_split, sq_rest = both[0].clone(), both[1].clone()
        if self._tp is not None:
            dist.all_reduce(sq_split, group=self._tp.group)
        return (sq_split + sq_rest).sqrt()

    # ---------------------------------------------------------- checkpoints

    @property
    def sharded(self) -> bool:
        """Whether a full state dict needs every process (a gather)."""
        return self._fsdp or self._tp is not None

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        if name in self.tp_split:
            parts = [torch.empty_like(t) for _ in range(self._tp.size)]
            dist.all_gather(parts, t.contiguous(), group=self._tp.group)
            t = torch.cat(parts, dim=self.tp_split[name])
        return t.detach().cpu()

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the single-process shapes, on the CPU
        (every process calls it: a sharded mode gathers)."""
        return {k: self._full(k, v) for k, v in self.model.state_dict().items()}

    def _param_names(self, optimizer) -> List[str]:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer) -> Dict:
        """``optimizer.state_dict()`` with every moment at its parameter's
        single-process shape, on the CPU (every process calls it)."""
        sd = optimizer.state_dict()
        names = self._param_names(optimizer)
        state = {i: {k: (self._full(names[i], v) if v.dim() else v.cpu())
                     for k, v in st.items()} for i, st in sd["state"].items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer, full: Dict) -> None:
        """Load a full optimizer state (``full_optimizer_state``, or any
        single-process one), cutting each moment to this process's shard."""
        names = self._param_names(optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for i, st in full["state"].items():
            i = int(i)
            state[i] = {k: (self._shard(names[i], params[i], v) if v.dim() else v)
                        for k, v in st.items()}
        optimizer.load_state_dict({"state": state, "param_groups": full["param_groups"]})

    def _shard(self, name: str, param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        if name in self.tp_split:
            dim = self.tp_split[name]
            n = full.shape[dim] // self._tp.size
            full = full.narrow(dim, self._tp.rank * n, n)
        full = full.to(self.dp.device)
        if hasattr(param, "device_mesh"):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(full.contiguous(), param.device_mesh, param.placements)
        return full


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def all_reduce_mean(values: Dict[str, torch.Tensor], dp: Optional[DataParallel]
                    ) -> Dict[str, torch.Tensor]:
    """Mean of 0-dim metrics over the processes (the global batch's, for
    equal per-process batches). The caller leaves out a metric that is
    already the global batch's (``acc_att``)."""
    if dp is None or dp.world <= 1 or not dist.is_initialized():
        return values
    keys = sorted(values)
    t = torch.stack([values[k].float().to(dp.device) for k in keys])
    dist.all_reduce(t)
    t /= dp.world
    return dict(zip(keys, t))
