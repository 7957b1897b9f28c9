"""Data-parallel training over several processes.

Counterpart of the JAX package's ``parallel/multihost.py`` on
``torch.distributed``:

* every rank calls ``initialize_distributed`` (``init_process_group`` on
  ``tcp://<coordinator-address>``, from the flags, or from torch's
  ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` in their
  absence); without a coordinator it does nothing (one process);
* the backend is ``nccl`` where each rank of the host has a GPU of its
  own, and ``gloo`` on the CPU or where ranks share a GPU (NCCL refuses two
  ranks on one device; ``ops/collectives.py`` moves CUDA tensors through
  the host for gloo); the choice is logged, and a failed init raises;
* each rank reads its own shard of the file list (``shard_files``, round
  robin) and batches of ``local_batch_size`` rows;
* the initial state is broadcast from rank 0 and checked equal on every
  rank (``replicate``: every rank builds it from the same seed), which
  takes the place of the JAX package's ``replicate`` and
  ``host_local_copy``; checkpoints are written by the coordinator
  (``is_coordinator``), metrics, plots and evaluation run there only.

``spawn`` runs a function in n new local processes; ``rank_device`` is
rank i's device, ``cuda:i`` modulo the visible GPUs.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Callable, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def choose_backend(device_type: str, local_world_size: int) -> str:
    """``nccl`` when every local rank has a GPU of its own, else ``gloo``."""
    import torch
    if device_type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _from_env() -> Tuple[Optional[str], Optional[int], Optional[int]]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    world, rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    return (f"{addr}:{port}" if addr and port else None,
            int(world) if world else None, int(rank) if rank else None)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda",
                           local_world_size: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group: ``coordinator_address`` (``host:port`` of
    rank 0), ``num_processes`` ranks, this one ``process_id``; the flags
    win over torch's environment variables.  Returns True when a process
    group was initialised (False: one process, nothing done).  On
    ``cuda`` the rank's device is ``cuda:<local rank>`` modulo the visible
    devices (``local rank = process_id % local_world_size``); the backend
    is ``choose_backend(device_type, local_world_size)``, where
    ``local_world_size`` defaults to ``LOCAL_WORLD_SIZE`` or, for a
    coordinator on this host, ``num_processes``."""
    import torch
    import torch.distributed as dist
    env_addr, env_world, env_rank = _from_env()
    coordinator_address = coordinator_address or env_addr
    if coordinator_address is None:
        return False
    num_processes = num_processes if num_processes is not None else env_world
    process_id = process_id if process_id is not None else env_rank
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs --num-processes and "
                         "--process-id (or WORLD_SIZE and RANK)")
    if local_world_size is None:
        host = coordinator_address.rsplit(":", 1)[0]
        local_world_size = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            num_processes if host in ("localhost", "127.0.0.1") else 1))
    backend = choose_backend(device_type, local_world_size)
    kwargs = {}
    if device_type == "cuda":
        device = rank_device(device_type, process_id, local_world_size)
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    log.info("process group: rank %d of %d, backend %s (%s, %d local "
             "ranks, %d visible GPUs), coordinator %s", process_id,
             num_processes, backend, device_type, local_world_size,
             torch.cuda.device_count(), coordinator_address)
    return True


def rank_device(device_type: str, process_id: int,
                local_world_size: int):
    """The device of a rank: ``cuda:<local rank>`` modulo the visible
    devices, or the CPU."""
    import torch
    if device_type != "cuda":
        return torch.device(device_type)
    local = process_id % local_world_size
    return torch.device("cuda", local % torch.cuda.device_count())


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the rank that writes checkpoints, metrics and plots (rank 0,
    or the only process)."""
    return process_index() == 0


def shard_files(files: Sequence, process_id: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """Round robin: rank i reads ``files[i::n]``."""
    pid = process_index() if process_id is None else process_id
    n = world_size() if process_count is None else process_count
    return list(files[pid::n])


def local_batch_size(global_batch_size: int,
                     process_count: Optional[int] = None) -> int:
    n = world_size() if process_count is None else process_count
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch_size {global_batch_size} must divide evenly over "
            f"{n} processes")
    return global_batch_size // n


def replicate(module, axis) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank 0 and
    check that each rank already held rank 0's values (every rank builds
    them from the same seed); raises naming the first that differs."""
    import torch
    if axis is None:
        return
    named = list(module.state_dict().items())
    for dtype in sorted({t.dtype for _, t in named}, key=str):
        group = [(k, t) for k, t in named if t.dtype == dtype]
        local = torch.cat([t.detach().reshape(-1) for _, t in group])
        ref = axis.broadcast_(local.clone(), 0)
        if not torch.equal(local, ref):
            off = 0
            for k, t in group:
                n = t.numel()
                if not torch.equal(local[off:off + n], ref[off:off + n]):
                    raise RuntimeError(
                        f"rank {axis.rank}: {k} differs from rank 0's "
                        "initial value")
                off += n


def spawn(fn: Callable, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (the ``spawn``
    start method) and wait for them; a rank that fails raises here."""
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=args, nprocs=nprocs, join=True,
                       start_method="spawn")
