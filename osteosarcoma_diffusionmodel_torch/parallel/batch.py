"""A global batch split over the ranks of a data group.

The JAX package's data parallelism is SPMD over one global batch: XLA
computes the global program, so a mesh run is the single-device run up to
reduction order. With one process per device, PyTorch computes only the
rank's rows; these helpers give the rank the global batch's numerics:

- :class:`BatchShard`: this rank's equal share of a global batch. Its
  :meth:`~BatchShard.sum` and :meth:`~BatchShard.mean` all-reduce over the
  group with an autograd-aware sum (the backward sums the gradient over
  the group too), so a batch statistic (a loss's mean, a correlation, a
  BatchNorm moment) is the global batch's on every rank. A rank that
  backpropagates ``loss / world`` then holds its rows' share of the global
  gradient, and the sum of the parameter gradients over the group is the
  global batch's gradient. ``world = 1`` without a group is one device:
  the same arithmetic, no collective.
- :func:`attached`: hands a shard to the modules that read batch rows
  (:class:`~..models.networks.Dropout` draws the global batch's mask from
  the shard's generator and keeps its rows;
  :class:`~..models.networks.BatchNorm` normalizes with the global
  moments) for the duration of a step.
- :class:`RowBlock` and :func:`gather_rows`: a cohort split into equal
  blocks of rows (the last zero-padded), and the all-gather of the
  blocks back into the cohort, for the sharded samplers.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient summed over it backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class RowBlock:
    """Rows ``[start, start + count)`` of a ``total``-row cohort; rows past
    the cohort's end read as zeros."""

    start: int
    count: int
    total: int

    @staticmethod
    def of(total: int, world: int, rank: int) -> "RowBlock":
        """Rank ``rank``'s block of ``total`` rows split over ``world``
        ranks: ceil(total / world) rows each, the cohort padded to
        world blocks."""
        per = pad_to_multiple(total, world) // world
        return RowBlock(rank * per, per, total)

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The block's rows of ``x`` along ``dim`` (whose size is
        ``total``), zero-padded to ``count``."""
        stop = min(self.start + self.count, self.total)
        part = x.narrow(dim, min(self.start, self.total), max(stop - self.start, 0))
        short = self.count - part.shape[dim]
        if short:
            pad = list(x.shape)
            pad[dim] = short
            part = torch.cat([part, x.new_zeros(pad)], dim=dim)
        return part


@dataclass(frozen=True)
class BatchShard:
    """This rank's equal share of a global batch over ``group`` (``world``
    ranks; None with one), and the generator of the step's dropout masks."""

    world: int = 1
    rank: int = 0
    group: Optional[object] = None
    generator: Optional[torch.Generator] = None

    def take(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global tensor (its size divides ``world``)."""
        if x is None or self.world == 1:
            return x
        return RowBlock.of(x.shape[0], self.world, self.rank).take(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group (differentiable)."""
        return x if self.group is None else all_reduce_sum(x, self.group)

    def mean(self, x: torch.Tensor, dim: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
        """The global batch's mean of ``x`` (this rank's rows) over every
        element (``dim`` None) or over the batch axis ``dim`` 0."""
        if dim is None:
            total, count = x.sum(), x.numel()
        else:
            total, count = x.sum(dim, keepdim=keepdim), x.shape[dim]
        return self.sum(total) / (count * self.world)


def batch_mean(x: torch.Tensor, shard: Optional[BatchShard], dim: Optional[int] = None,
               keepdim: bool = False) -> torch.Tensor:
    """``x.mean`` without a shard; the global batch's mean with one."""
    if shard is None:
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    return shard.mean(x, dim, keepdim)


def batch_sum(x: torch.Tensor, shard: Optional[BatchShard]) -> torch.Tensor:
    """``torch.sum(x)`` over the global batch's rows."""
    total = torch.sum(x)
    return total if shard is None else shard.sum(total)


@contextmanager
def attached(module: nn.Module, shard: BatchShard) -> Iterator[None]:
    """``shard`` on every submodule with a ``shard`` attribute (dropout,
    BatchNorm) for the block's duration."""
    parts = [m for m in module.modules() if hasattr(m, "shard")]
    for m in parts:
        m.shard = shard
    try:
        yield
    finally:
        for m in parts:
            m.shard = None


def all_gather_rows(group, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` (equal shapes) stacked along rows in rank
    order: ``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo."""
    world = dist.get_world_size(group)
    local = local.contiguous()
    if dist.get_backend(group) == "nccl":
        out = local.new_empty((world * local.shape[0],) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, local, group=group)
        return out
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)


def gather_rows(group, local: torch.Tensor, total: int) -> torch.Tensor:
    """The cohort from each rank's :class:`RowBlock` of it: gathered in
    rank order, the padding cut."""
    return all_gather_rows(group, local)[:total]


def all_reduce_grads(grads, group) -> None:
    """Sum the gradients over ``group`` in place, in one flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
