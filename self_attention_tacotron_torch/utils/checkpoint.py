"""Training checkpoints: periodic saves with retention, resume, warm start.

Counterpart of the JAX package's ``utils/checkpoint.py`` on ``torch.save``
instead of orbax.  A checkpoint of step n is two files in the directory:
``model-<n>.pt``, the model's state dict as ``utils/convert.py``
``save_checkpoint`` writes it (so ``cli/predict.py`` restores it as it
is), and ``train-<n>.pt`` with the optimizer state and the step.
``warm_start`` copies the parameters whose flax path ("decoder/
attention_lstm/kernel", ``utils/convert.py`` ``flax_param_paths``) matches
one of the regexes from another run's checkpoint.

Under a process group (data parallelism) the coordinator (rank 0) decides
whether a step is saved and writes the files; every rank learns its
decision and waits at a barrier until the files are there, so that a rank
never reads a half-written checkpoint or decides otherwise from a
directory that is being written.  Every rank restores.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Sequence

import torch

from .convert import flax_param_paths, save_checkpoint


def _steps(directory: str) -> List[int]:
    found = []
    for p in glob.glob(os.path.join(directory, "model-*.pt")):
        m = re.search(r"model-(\d+)\.pt$", p)
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


class CheckpointManager:
    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_steps = max(int(save_interval_steps), 1)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _due(self, step: int, force: bool) -> bool:
        if step in self.all_steps():
            return False
        return bool(force or step % self.save_interval_steps == 0)

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` (a ``parallel.train_step.TrainState``) at ``step``
        when it falls on the interval or ``force``; drop the oldest
        checkpoints past ``max_to_keep``.  False when nothing was saved.
        Under a process group every rank must call it."""
        import torch.distributed as dist
        if not dist.is_initialized():
            return self._due(step, force) and self._write(step, state)
        decision = [self._due(step, force) if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(decision, src=0)
        if decision[0]:
            if dist.get_rank() == 0:
                self._write(step, state)
            dist.barrier()
        return bool(decision[0])

    def _write(self, step: int, state) -> bool:
        save_checkpoint(state.model, self.directory, step)
        torch.save({"step": int(step),
                    "optimizer": state.optimizer.state_dict()},
                   os.path.join(self.directory, f"train-{step}.pt"))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                for name in (f"model-{old}.pt", f"train-{old}.pt"):
                    path = os.path.join(self.directory, name)
                    if os.path.exists(path):
                        os.remove(path)
        return True

    def restore(self, state, step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint ``step`` (the newest when None) into ``state``;
        returns its step, or None when there is none."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        model_state = torch.load(
            os.path.join(self.directory, f"model-{step}.pt"),
            map_location="cpu", weights_only=True)
        state.model.load_state_dict(model_state, strict=True)
        train = torch.load(os.path.join(self.directory, f"train-{step}.pt"),
                           map_location="cpu", weights_only=True)
        state.optimizer.load_state_dict(train["optimizer"])
        state.step = int(train["step"])
        return state.step


@torch.no_grad()
def warm_start(model: torch.nn.Module, ckpt_dir: str,
               vars_to_warm_start: Sequence[str],
               step: Optional[int] = None) -> List[str]:
    """Copy into ``model`` every parameter of checkpoint ``step`` (the
    newest when None) in ``ckpt_dir`` whose flax path matches one of the
    regexes and whose shape agrees; the rest keep their values.  Returns
    the flax paths copied."""
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    step = steps[-1] if step is None else int(step)
    old = torch.load(os.path.join(ckpt_dir, f"model-{step}.pt"),
                     map_location="cpu", weights_only=True)
    patterns = [re.compile(p) for p in vars_to_warm_start]
    names = dict(zip((id(p) for p in model.parameters()),
                     (k for k, _ in model.named_parameters())))
    copied = []
    for path, param in flax_param_paths(model):
        value = old.get(names[id(param)])
        if (value is not None and value.shape == param.shape
                and any(p.search(path) for p in patterns)):
            param.copy_(value)
            copied.append(path)
    return copied
