"""The system under test: batch-1 serving through the port's
``parallel.make_predict_step``, as ``cli.predict`` serves.

``Server`` builds the configuration's model on the device, loads the
benchmark's weights into it with ``load_state_dict`` and serves one
request a call: the host-side ``Batch`` is made, moved to the device, run
through ``make_predict_step(hp)(model, batch)`` and its outputs (the
decoded steps, the code logits and the stop logit of every step) read back
to the host.  It also reads the program's launch counters of the kernels
the cell's counts name and every warning the program logs (a kernel gate
that refuses the call logs one), for the check.
"""

from __future__ import annotations

import contextlib
import logging
from typing import List

import torch


class WarningLog(logging.Handler):
    """Keeps every WARNING or worse record the program logs."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(f"{record.name}: {record.getMessage()}")


def hparams(config: dict):
    """The configuration's hparams as ``cli.predict`` loads a recipe file:
    the defaults, then the file's keys."""
    import json
    from self_attention_tacotron_torch.config import default_hparams
    return default_hparams().parse_json(json.dumps(config["hparams"]))


def kernel_counters(counts) -> dict:
    """{count: launches} of the program's kernels that the cell's counts
    name a launch counter for."""
    import importlib
    out = {}
    for name, count in counts.items():
        if count.COUNTER is not None:
            module, function = count.COUNTER
            out[name] = getattr(importlib.import_module(module),
                                function).launches
    return out


def build_kernels(device, counts) -> None:
    """Builds (or finds already built) the libraries of the cell's kernels."""
    libraries = sorted({c.LIBRARY for c in counts.values()
                        if c.LIBRARY is not None})
    if device.type == "cuda" and libraries:
        from self_attention_tacotron_torch.ops import cuda_build
        cuda_build.build_all(libraries)


def model_shapes(config: dict):
    """(name, shape) of every entry of the model's state dict, from a
    model built on the meta device (no memory, no initialisation)."""
    from self_attention_tacotron_torch.models import tacotron_model_factory
    with torch.device("meta"):
        model = tacotron_model_factory(hparams(config))
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


class Server:
    def __init__(self, config: dict, weights, device):
        from self_attention_tacotron_torch.models import (
            Batch, tacotron_model_factory)
        from self_attention_tacotron_torch.parallel import make_predict_step
        self.hp = hparams(config)
        self.device = device
        self.Batch = Batch
        with torch.device(device):
            model = tacotron_model_factory(self.hp)
        model.load_state_dict(weights, strict=True)
        self.model = model.eval()
        self.predict_step = make_predict_step(self.hp)
        self.r = self.hp.outputs_per_step

    def __call__(self, req, spans) -> dict:
        with spans("make_request"):
            batch = self.Batch(
                source=torch.from_numpy(req.source[None]),
                source_length=torch.tensor([req.source.shape[0]]),
                speaker_id=(None if req.speaker is None
                            else torch.tensor([req.speaker])))
        with spans("to_device"):
            batch = batch.to(self.device)
        with spans("predict_step"):
            out = self.predict_step(self.model, batch)[-1]
        with spans("readback"):
            steps = int(out.lengths[0])
            logits = out.outputs[0, :steps * self.r].cpu()
            stop = out.stop_token[0, :steps, 0].cpu()
        return dict(steps=steps, logits=logits, stop=stop)

    def close(self):
        del self.model, self.predict_step


@contextlib.contextmanager
def no_span(name):
    yield
