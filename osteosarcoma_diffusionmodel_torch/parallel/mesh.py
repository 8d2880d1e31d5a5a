"""The (data, model) device mesh on torch.distributed.

Counterpart of osteosarcoma_diffusionmodel_tpu/parallel/mesh.py. The JAX
package runs one controller over every device of a ``Mesh`` and lets XLA
insert the collectives; PyTorch runs one process per device (``torchrun
--nproc-per-node N``), joined in a process group: NCCL on the cards, gloo
on the CPU. :func:`make_mesh` lays the group's ranks out as a
``DeviceMesh`` of shape (n // model_parallel, model_parallel) named
(``data``, ``model``).

- ``data``: the batch/cohort axis. A rank holds a contiguous block of the
  rows (:func:`shard_batch`, :func:`data_shard`); a row count that does not
  divide the axis is replicated on every rank, as the JAX package's
  ``NamedSharding`` requires even shards.
- ``model``: the tensor-parallel axis. :func:`denoiser_param_sharding`
  picks the JAX rule's parameters (a feature axis of at least 128 that
  divides the axis); :func:`parallelize_denoiser` runs each such Linear
  column-parallel (:class:`ColumnParallelLinear`: the rank's output
  features, then an all-gather of the output), so GroupNorm after it sees
  whole rows, as XLA computes the JAX layout. Norm scales that the rule
  selects stay whole in the forward: the gather comes before the norm.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .batch import BatchShard, RowBlock, all_gather_rows

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group of ``coordinator_address`` ("host:port" or an
    init URL such as ``file://...``), or of the launcher's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as torchrun
    sets them). A no-op without either, or when a group exists. The backend
    defaults to NCCL where a card is visible (the rank's card, ``LOCAL_RANK``,
    becomes the current device) and gloo on the CPU. Returns True when a
    group is initialized."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not addr:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        # An explicit process_id=0 is kept: 0 is a valid rank.
        process_id = int(env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id,
        timeout=None if timeout_s is None else timedelta(seconds=timeout_s))
    return True


def group_devices() -> int:
    """The devices of the process group: its world size (one process per
    device), 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """True on the rank that writes files: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the process group's ranks
    (``devices``: global ranks, default all), the first ``num_devices``
    of them when given."""
    if devices is None:
        devices = range(group_devices())
    devices = list(devices)
    if num_devices is not None:
        if len(devices) < num_devices:
            hint = "" if dist.is_initialized() else (
                " (no process group: run one process per device, e.g. torchrun "
                f"--nproc-per-node {num_devices}, or call initialize_distributed)")
            raise ValueError(f"requested a {num_devices}-device mesh but only "
                             f"{len(devices)} devices are visible{hint}")
        devices = devices[:num_devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group (initialize_distributed, torchrun)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(devices, dtype=torch.int64).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The leading (batch/cohort) axis over ``data``, replicated over
    ``model``: the DTensor placements of the JAX ``P("data")``."""
    del mesh
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    del mesh
    return (Replicate(), Replicate())


def shard_batch(mesh: DeviceMesh, *arrays: torch.Tensor):
    """This rank's contiguous rows of each array, where its row count
    divides the data axis; the whole array (replicated) otherwise."""
    n = axis_size(mesh, DATA_AXIS)
    r = axis_rank(mesh, DATA_AXIS)
    out = tuple(a if a.shape[0] % n else RowBlock.of(a.shape[0], n, r).take(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def data_shard(mesh: Optional[DeviceMesh], rows: int,
               generator: Optional[torch.Generator] = None) -> BatchShard:
    """The :class:`BatchShard` of a ``rows``-row global batch: this rank's
    share over the data group where ``rows`` divides the axis (a one-rank
    axis too: its collectives still run), else the whole batch with no
    collective (replicated, or no mesh)."""
    if mesh is None:
        return BatchShard(generator=generator)
    n = axis_size(mesh, DATA_AXIS)
    if rows % n:
        return BatchShard(generator=generator)
    return BatchShard(n, axis_rank(mesh, DATA_AXIS), axis_group(mesh, DATA_AXIS), generator)


# ----------------------------------------------------------------------
# Tensor parallelism over the model axis
# ----------------------------------------------------------------------
def _feature_dim(name: str, param: torch.Tensor, linear_weights: set) -> int:
    """The axis the JAX rule reads: a Flax Dense kernel's last axis is its
    output features, which are a torch Linear weight's axis 0; the raw
    arrays keep the Flax layout."""
    return 0 if name in linear_weights else param.ndim - 1


def denoiser_param_sharding(mesh: DeviceMesh, module: nn.Module) -> Dict[str, object]:
    """Each parameter's placement over the model axis, by the JAX rule
    (:101-124 there): ``Shard`` of its feature axis when that axis has at
    least 128 entries and divides the model axis (size > 1), else
    ``Replicate``."""
    model_size = axis_size(mesh, MODEL_AXIS)
    linear_weights = {f"{n}.weight" for n, m in module.named_modules()
                      if isinstance(m, (nn.Linear, ColumnParallelLinear))}
    out = {}
    for name, p in module.named_parameters():
        if model_size == 1 or p.ndim == 0:
            out[name] = Replicate()
            continue
        dim = _feature_dim(name, p, linear_weights)
        feat = p.shape[dim]
        out[name] = Shard(dim) if feat % model_size == 0 and feat >= 128 else Replicate()
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input's gradient summed over the model group
    backward (each rank's columns see the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' output columns gathered into whole rows forward (in f32);
    the rank's columns of the gradient backward (the layers after it run
    on every rank of the group alike)."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.cols, ctx.rank = y.shape[-1], rank
        parts = all_gather_rows(group, y.float().unsqueeze(0))
        return torch.cat(list(parts), dim=-1).to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.cols
        return grad[..., lo: lo + ctx.cols].contiguous(), None, None


class ColumnParallelLinear(nn.Module):
    """A Linear over this rank's output features (``weight`` rows, ``bias``
    entries), its output gathered over the model group. Runs in the
    wrapped layer's ``compute_dtype`` where it has one."""

    def __init__(self, linear: nn.Linear, group, rank: int, size: int):
        super().__init__()
        per = linear.out_features // size
        rows = slice(rank * per, (rank + 1) * per)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = nn.Parameter(linear.bias.detach()[rows].clone())
        self.compute_dtype = getattr(linear, "compute_dtype", None)
        self.group, self.rank = group, rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            x, w, b = x.to(self.compute_dtype), w.to(self.compute_dtype), b.to(self.compute_dtype)
        return _GatherColumns.apply(F.linear(x, w, b), self.group, self.rank)


def parallelize_denoiser(mesh: DeviceMesh, module: nn.Module) -> nn.Module:
    """Swap, in place, every Linear of ``module`` whose weight
    :func:`denoiser_param_sharding` shards for a :class:`ColumnParallelLinear`
    over the model axis. Returns ``module``."""
    size = axis_size(mesh, MODEL_AXIS)
    if size == 1:
        return module
    specs = denoiser_param_sharding(mesh, module)
    group, rank = axis_group(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    for name, sub in list(module.named_modules()):
        if isinstance(sub, nn.Linear) and specs[f"{name}.weight"] == Shard(0):
            parent_name, _, attr = name.rpartition(".")
            parent = module.get_submodule(parent_name) if parent_name else module
            setattr(parent, attr, ColumnParallelLinear(sub, group, rank, size))
    return module


def sharded_names(module: nn.Module) -> set:
    """The names of the parameters a :func:`parallelize_denoiser` module
    holds only a shard of."""
    return {f"{n}.{leaf}" for n, m in module.named_modules()
            if isinstance(m, ColumnParallelLinear) for leaf in ("weight", "bias")}


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every column-parallel shard gathered
    over its model group: the unsharded layer's weights (collective: every
    rank of the group calls it)."""
    state = dict(module.state_dict())
    for name, m in module.named_modules():
        if isinstance(m, ColumnParallelLinear):
            for leaf in ("weight", "bias"):
                part = getattr(m, leaf).detach()
                state[f"{name}.{leaf}"] = all_gather_rows(m.group, part).to(part.dtype)
    return state
