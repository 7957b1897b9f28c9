"""The data axis of data-parallel training: sums over the ranks of a
``torch.distributed`` process group, scoped to a training step.

The JAX package shards the batch over a mesh axis and lets GSPMD compute
every batch reduction over the global batch: the batch-norm statistics,
the losses' valid-element counts and the gradient.  Here each rank holds
its local rows, and the modules that reduce over the batch call
``global_sum`` inside ``data_axis(axis)``, the scope ``parallel.
train_step`` opens around a step.  Outside it (one process, or work that
one rank does alone, such as the coordinator's evaluation) ``global_sum``
returns its argument as it is, so a run without a process group computes
what it did before data parallelism.

A ``gloo`` group moves tensors through the host: a CUDA tensor is copied
to the CPU, summed there and copied back (two ranks that share one card
cannot use NCCL).  Every rank must call the same sums in the same order.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch


class DataAxis:
    """The ranks of a process group, as the batch axis of training."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.host_staged = self.backend == "gloo"

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks in place (no gradient); returns x."""
        import torch.distributed as dist
        if self.host_staged and x.device.type != "cpu":
            host = x.detach().cpu()
            dist.all_reduce(host, group=self.group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=self.group)
        return x

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, with the gradient of a sum:
        each rank's gradient of the result, summed over the ranks
        (``torch.distributed.nn.functional.all_reduce``)."""
        from torch.distributed.nn.functional import all_reduce
        if self.host_staged and x.device.type != "cpu":
            return all_reduce(x.cpu(), group=self.group).to(x.device)
        return all_reduce(x, group=self.group)

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        import torch.distributed as dist
        if self.host_staged and x.device.type != "cpu":
            host = x.detach().cpu()
            dist.broadcast(host, src, group=self.group)
            x.copy_(host)
        else:
            dist.broadcast(x, src, group=self.group)
        return x


_AXIS: contextvars.ContextVar = contextvars.ContextVar("data_axis",
                                                       default=None)


@contextlib.contextmanager
def data_axis(axis: Optional[DataAxis]):
    """Scope ``axis`` (None: no data parallelism) over the batch
    reductions computed inside the context."""
    token = _AXIS.set(axis)
    try:
        yield axis
    finally:
        _AXIS.reset(token)


def current_axis() -> Optional[DataAxis]:
    return _AXIS.get()


def axis_rank() -> int:
    """This rank's index on the scoped data axis (0 without one)."""
    axis = _AXIS.get()
    return 0 if axis is None else axis.rank


def global_sum(x: torch.Tensor, differentiable: bool = False
               ) -> torch.Tensor:
    """``x`` summed over the scoped data axis; ``x`` itself without one.
    ``differentiable`` keeps the graph (the gradient of a sum)."""
    axis = _AXIS.get()
    if axis is None:
        return x
    if differentiable:
        return axis.all_reduce(x)
    return axis.all_reduce_(x.detach().clone())
