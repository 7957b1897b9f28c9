"""The model-wide compute dtype (``hp.compute_dtype``), flax's ``dtype`` rule.

Counterpart of the ``dtype`` field that every module of the JAX package
carries (``compute_dtype=bfloat16`` there is the XLA path's model-wide
bf16).  It is not an autocast: parameters, batch-norm statistics,
checkpoints, gradients and the optimizer stay float32, and each module
casts its input and its float32 parameters to its ``dtype`` where it uses
them and returns ``dtype``, as flax's ``nn.Dense(dtype=...)`` does.  Every
elementwise op between two such tensors then runs in that dtype too: the
softmax of a self-attention hop and the zoneout mix run in bf16, where
``torch.autocast`` would move softmax, exp and sums to float32.  The
gradient of each cast is the cast back, so parameter gradients come out
float32, as the JAX cast's VJP gives them.

* ``compute_dtype(name)`` — ``torch.bfloat16`` for ``"bfloat16"``, float32
  for any other string (as the JAX package's ``models/tacotron.py``);
* ``cast(owner, p, dtype)`` — the parameter ``p`` of ``owner`` in
  ``dtype``; without autograd cast once for as long as its value stands,
  not once a use (a decode loop uses each weight at every step);
* ``Linear`` — ``nn.Linear`` with a ``dtype``: in bf16 the input, weight
  and bias are cast and the bias is added after the product (two roundings,
  as flax's ``Dense``); in float32 it is ``nn.Linear`` itself;
* ``set_compute_dtype(root, dtype)`` — sets ``dtype`` on every module under
  ``root`` whose class declares one (a class attribute, float32 by
  default);
* ``weak(value, dtype)`` — a Python scalar as JAX's weak typing uses it
  beside an array of ``dtype``: rounded to that dtype first (0.9 is
  0.8984375 beside bf16), where torch would keep it in float32;
* ``sigmoid``, ``softmax``, ``log_softmax`` — in float32 torch's own ops;
  in bf16 the JAX package's formulas one op at a time, each rounded to
  bf16 as XLA rounds them (``1 / (1 + exp(-x))``; ``exp(x - max)`` over
  its sum; ``x - max - log(sum(exp(x - max)))``), where torch's fused ops
  round once from float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def cast(owner: nn.Module, p: torch.Tensor, dtype: torch.dtype
         ) -> torch.Tensor:
    """``p`` in ``dtype``.  Where autograd records for ``p`` this is a
    fresh cast at each use: each use's gradient then becomes float32 before
    the uses are summed, as the JAX cast inside a scan body gives it (one
    kept copy would sum them in ``dtype``).  Elsewhere (serving,
    evaluation) the copy is kept on ``owner`` and made anew when the
    storage, device or in-place version of ``p`` changes (an optimizer
    step, a ``load_state_dict``, a move: the key of the fused kernels'
    merged weights); the cast is deterministic, so it equals a fresh one."""
    if p.dtype == dtype or (p.requires_grad and torch.is_grad_enabled()):
        return p.to(dtype)
    key = (p.data_ptr(), p.device, p._version, dtype)
    casts = owner.__dict__.setdefault("_casts", {})
    hit = casts.get(id(p))
    if hit is None or hit[0] is not p or hit[1] != key:
        hit = casts[id(p)] = (p, key, p.to(dtype))
    return hit[2]


class Linear(nn.Linear):
    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.dtype), cast(self, self.weight, self.dtype))
        return (y if self.bias is None
                else y + cast(self, self.bias, self.dtype))


def set_compute_dtype(root: nn.Module, dtype: torch.dtype) -> nn.Module:
    for m in root.modules():
        if isinstance(getattr(type(m), "dtype", None), torch.dtype):
            m.dtype = dtype
    return root


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim)
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))
