"""The data axis and the batch's split over it.

Counterpart of the JAX package's ``parallel/mesh.py``.  There the batch is
sharded over the ``data`` axis of a device mesh and the parameters are
replicated; here the data axis is the ``torch.distributed`` process group:
its size is the world size, rank r holds rows ``[r * n, (r + 1) * n)`` of
a global batch of ``size * n`` rows (``shard_batch``), every rank holds the
whole model, and the train step sums the gradient over the ranks
(``parallel/train_step.py``).  The model fits on one device, so the port
has no other axis: a ``hp.mesh_shape`` of more than one axis, or whose
product is not the world size, is refused here, where the JAX package only
asserts when it traces the fused trunk.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..ops.collectives import DataAxis


def check_mesh_shape(mesh_shape: Sequence[int], world_size: int) -> None:
    """Raise ``ValueError`` unless ``mesh_shape`` is () or the one data
    axis of ``world_size`` ranks."""
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) > 1:
        raise ValueError(
            f"hp.mesh_shape={shape}: the port shards the batch over one "
            "data axis (the process group) only; give () or "
            f"({world_size},)")
    if shape and shape[0] != world_size:
        raise ValueError(
            f"hp.mesh_shape={shape} does not match the {world_size} ranks of "
            f"the process group; give () or ({world_size},)")


def create_mesh(mesh_shape: Sequence[int] = (), group=None
                ) -> Optional[DataAxis]:
    """The data axis over the process group (the default group when
    ``group`` is None), or None without an initialised process group;
    ``mesh_shape`` (``hp.mesh_shape``) is checked against its size."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        check_mesh_shape(mesh_shape, 1)
        return None
    axis = DataAxis(group)
    check_mesh_shape(mesh_shape, axis.size)
    return axis


def shard_batch(batch, axis: Optional[DataAxis]):
    """This rank's rows of a global ``models.Batch`` (every tensor's leading
    axis, ``Batch.map``).  The batch must divide evenly."""
    if axis is None or axis.size == 1:
        return batch
    B = batch.source.shape[0]
    if B % axis.size:
        raise ValueError(f"a batch of {B} rows does not divide over the "
                         f"{axis.size} ranks of the data axis")
    n = B // axis.size
    rows = slice(axis.rank * n, (axis.rank + 1) * n)
    return batch.map(lambda x: x[rows])
