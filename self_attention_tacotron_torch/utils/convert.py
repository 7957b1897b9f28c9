"""The weight bridge from the JAX package's parameter tree, and the port's
own checkpoints.

``from_flax`` maps ``{"params": ..., "batch_stats": ...}`` with numpy
leaves to a state dict of the port's modules, whose submodules carry the
flax names (``encoder.cbhg.trunk.conv_bank.conv1d_K3.conv.weight``):

* 2-D ``kernel`` (in, out) -> ``weight`` (out, in): ``nn.Linear`` and the
  zoneout LSTM cell (kernel (in + u, 4u) -> (4u, in + u), gate order
  i, g, f, o kept; the +1 forget bias is added at call time, not stored);
* 3-D ``kernel`` (K, in, out) -> ``weight`` (out, in, K): ``nn.Conv``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, batch_stats
  ``mean``/``var`` -> ``running_mean``/``running_var`` (epsilon 1e-3 lives
  in the module);
* a GRU cell's ``gates/kernel`` and ``candidate/kernel`` (in + u, 2u / u)
  -> the ``gates`` and ``candidate`` linear layers' ``weight`` (transposed)
  and their ``/bias`` -> ``bias`` (``cbhg/bigru/{fw,bw}``);
* ``embedding`` -> ``weight``; every other leaf keeps its name
  (ForwardAttention's ``attention_variable`` (1, U) and ``attention_bias``,
  AdditiveAttention's ``attention_v``);
* the speaker parameters map like any other: ``speaker_embedding/
  embedding``, ``speaker_projection``, the decoder's speaker prenet
  ``decoder/prenets/prenet_0/{dense0,speaker_projection,dense}`` and the
  postnet's ``speaker_projection``.  An ``ExternalEmbedding``'s table lives
  in the JAX package's ``constants`` collection and in no state dict: both
  read it from its file;
* so do the rest of the model surface's: ``accent_embedding/embedding``,
  ``encoder/{prenets,accent_type_prenets}``, ``encoder/conv_<i>`` and
  ``encoder/bilstm`` (``EncoderV2``), ``decoder/{mgc,lf0}_prenets``,
  ``decoder/{mgc_out_projection1,mgc_out_projection2,lf0_out_projection}``,
  ``.../attention_mechanism_<i>/transition_factor_projection`` and
  ``PostNetCBHG``'s ``cbhg`` and ``linear_projection``: the port's modules
  carry the flax names, so no leaf needs a rule of its own.

``to_flax`` is the inverse.  Loading orbax checkpoints would need JAX and
is not part of the port; ``save_checkpoint``/``load_checkpoint`` write and
read ``torch.save`` files of the state dict.  ``init_parameters`` draws the
weights of a model from a seed (glorot-uniform matrices, the highway
transform gate's -1 bias, identity batch norm), independent of the device;
an ``ExternalEmbedding``'s table comes from its file and is left alone.
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"scale": "weight", "embedding": "weight",
                  "mean": "running_mean", "var": "running_var"}
_LEAF_TO_FLAX = {"running_mean": "mean", "running_var": "var"}


def _walk(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    else:
        yield prefix, tree


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(collection, {})):
            arr = np.asarray(leaf, np.float32)
            *mods, name = path
            *sub, name = name.split("/")    # a GRU cell's "gates/kernel"
            mods += sub
            if name == "kernel":
                name = "weight"
                arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
            else:
                name = _LEAF_TO_TORCH.get(name, name)
            out[".".join(mods + [name])] = torch.from_numpy(
                np.array(arr, np.float32, copy=True))
    return out


def _flax_namer(model: nn.Module):
    """key -> (collection, module path, flax leaf name, is a kernel)."""
    embeddings = {n for n, m in model.named_modules()
                  if type(m).__name__ == "Embedding"}
    norms = {n for n, m in model.named_modules()
             if type(m).__name__ == "BatchNorm"}
    grus = {n for n, m in model.named_modules()
            if type(m).__name__ == "GRUCell"}

    def name_of(key: str):
        *mods, name = key.split(".")
        owner = ".".join(mods)
        collection, is_kernel = "params", False
        if name in _LEAF_TO_FLAX:
            collection, leaf = "batch_stats", _LEAF_TO_FLAX[name]
        elif name == "weight" and owner in embeddings:
            leaf = "embedding"
        elif name == "weight" and owner in norms:
            leaf = "scale"
        elif name == "weight":
            leaf, is_kernel = "kernel", True
        else:
            leaf = name
        if ".".join(mods[:-1]) in grus:     # the cell's "gates/kernel"
            mods, leaf = mods[:-1], f"{mods[-1]}/{leaf}"
        return collection, mods, leaf, is_kernel
    return name_of


def flax_param_paths(model: nn.Module):
    """(path, parameter) pairs, the path '/'-joined as in the JAX params
    tree ("decoder/attention_lstm/kernel").  The tensors are the model's
    own, in the port's layout."""
    name_of = _flax_namer(model)
    out = []
    for key, p in model.named_parameters():
        _, mods, name, _ = name_of(key)
        out.append(("/".join(mods + [name]), p))
    return out


def to_flax(state: Dict[str, torch.Tensor], model: nn.Module) -> dict:
    """The port's state dict -> {"params", "batch_stats"} numpy tree."""
    name_of = _flax_namer(model)
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        collection, mods, name, is_kernel = name_of(key)
        arr = value.detach().cpu().numpy()
        if is_kernel:
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        node = tree[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (every entry must match)."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Deterministic weights from ``seed`` (numpy), the same on any device."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() >= 2:
            if p.dim() == 3:   # conv (out, in, K)
                fan_in, fan_out = p.shape[1] * p.shape[2], p.shape[0] * p.shape[2]
            else:              # (out, in); (1, U) energy vectors
                fan_out, fan_in = p.shape[0], p.shape[1]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            vals = rng.uniform(-lim, lim, tuple(p.shape))
        elif re.search(r"highway_\d+\.T\.bias$", name):
            vals = np.full(tuple(p.shape), -1.0)
        elif name.endswith(".gates.bias"):     # a GRU cell's gate bias
            vals = np.ones(tuple(p.shape))
        elif leaf == "weight":  # batch-norm scale
            vals = np.ones(tuple(p.shape))
        else:
            vals = np.zeros(tuple(p.shape))
        p.copy_(torch.from_numpy(vals.astype(np.float32)))
    stored = set(model.state_dict())   # not the frozen external tables
    for name, b in model.named_buffers():
        if name in stored:
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model


def save_checkpoint(model: nn.Module, directory: str, step: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"model-{step}.pt")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path


def load_checkpoint(model: nn.Module, directory: str,
                    step: Optional[int] = None) -> Optional[int]:
    """Load ``model-<step>.pt`` (the newest when ``step`` is None) into
    ``model``; returns the step, or None when there is no checkpoint."""
    paths = glob.glob(os.path.join(directory, "model-*.pt"))
    steps = {int(re.search(r"model-(\d+)\.pt$", p).group(1)): p
             for p in paths}
    if not steps:
        return None
    step = max(steps) if step is None else int(step)
    state = torch.load(steps[step], map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return step
