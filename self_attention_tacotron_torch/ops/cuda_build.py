"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` (plus the shared ``csrc/*.cuh``
headers) compiled for Hopper (``sm_90a``) into a shared library with a
plain C interface.  Builds happen at first use, into ``build/torch_kernels/``
at the root of the checkout; the library name carries a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is reused.
``build_all`` starts one nvcc per kernel at once and waits for all of them.

Nothing here falls back: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    return log


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Build every named kernel in parallel; returns each build's log
    (empty where the library was already built)."""
    jobs = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, job) for n, job in jobs.items()}


class KernelLaunch:
    """A prepared launch: the C argument struct, the tensors it points to,
    preallocated outputs and scratch (and, when profiling, what the kernel
    writes its profile to: per-stage cycle counts, or timer stamps).  Each
    call launches the kernel on the current stream, raises on a non-zero
    cudaError_t, adds one to ``owner.launches`` (or to the ``counter`` it
    names: a kernel's bf16 instance counts in ``launches_bf16``) and
    returns the outputs."""

    def __init__(self, fn, args, keep, outputs, device, owner,
                 stage_cycles=None, counter: str = "launches"):
        self.fn, self.args, self.keep = fn, args, keep
        self.outputs, self.device, self.owner = outputs, device, owner
        self.stage_cycles, self.counter = stage_cycles, counter

    def __call__(self):
        import torch
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = self.fn(ctypes.byref(self.args), stream)
        if err != 0:
            raise RuntimeError(f"{self.owner.__name__} launch failed: "
                               f"cudaError {err}")
        setattr(self.owner, self.counter,
                getattr(self.owner, self.counter) + 1)
        return self.outputs


_tickets: dict = {}


def ticket_words(device, n: int, kernel: str):
    """The ticket counters of ``kernel`` on ``device`` (int32 words, one a
    group of blocks that merges in the last block to arrive): zeroed once,
    and left at 0 by every launch (its last block resets its word), so
    launches on one stream share them.  Grown (new zeros) for more."""
    import torch
    words = _tickets.get((kernel, device))
    if words is None or words.numel() < n:
        words = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[(kernel, device)] = words
    return words


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
