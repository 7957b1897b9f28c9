"""The training step on one device.

Counterpart of the JAX package's ``parallel/train_step.py``
``make_optimizer``, ``create_train_state`` and ``make_train_step``:
global-norm clipping at 1.0, then Adam (``adam_beta1``, ``adam_beta2``,
``adam_eps``) whose update n (counted from 0, as optax counts) runs at
``noam_learning_rate(initial_learning_rate, n)`` when
``decay_learning_rate``.  Dropout and zoneout of step n draw from a
``torch.Generator`` seeded with (``hp.seed``, n), so a resumed run draws
what an unbroken one would have.  The metrics are ``loss``, the main loss
(``code_loss``, or ``mel_loss`` and with a postnet ``postnet_loss``),
``done_loss``, ``l2_regularization_loss``, ``learning_rate`` and
``grad_norm`` (the norm before clipping), as tensors on the model's device;
``with_alignments`` also returns row 0's source alignments and outputs of
the TRAIN forward, detached, for the train-time plots.
``make_eval_step`` is the two-pass evaluation (a free-running and a
teacher-forced VALIDATION decode); ``make_predict_step`` is serving, with
``use_forced_alignment_mode`` a second decode that replays the first's
alignments.  Data parallelism comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..config import HParams
from ..models.tacotron import Batch, TacotronOutput, compute_loss
from ..ops.losses import global_norm_clip, noam_learning_rate


class TrainState:
    """The model (parameters and batch statistics), its optimizer and the
    number of updates taken."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step


def make_optimizer(hp: HParams, params) -> torch.optim.Adam:
    """Adam over ``params``; the train step sets each update's rate."""
    return torch.optim.Adam(params, lr=hp.initial_learning_rate,
                            betas=(hp.adam_beta1, hp.adam_beta2),
                            eps=hp.adam_eps)


def create_train_state(model: nn.Module, hp: HParams) -> TrainState:
    return TrainState(model, make_optimizer(hp, list(model.parameters())))


def learning_rate(hp: HParams, step: int) -> float:
    if hp.decay_learning_rate:
        return noam_learning_rate(hp.initial_learning_rate, step,
                                  hp.learning_rate_step_factor)
    return hp.initial_learning_rate


def step_generator(hp: HParams, step: int, device) -> torch.Generator:
    """The dropout and zoneout generator of update ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hp.seed) & 0xFFFFFFFF) << 32 | int(step))
    return gen


def make_train_step(hp: HParams, with_alignments: bool = False) -> Callable:
    """``train_step(state, batch) -> metrics``; updates ``state`` in place.
    With ``with_alignments`` it returns ``(metrics, (alignments, outputs))``:
    row 0 of each source's (T_mem, S) alignments and its (S, C) outputs from
    the TRAIN forward, detached (on the fused trunk, the alignments its
    kernel saves; the JAX package's ``make_train_step(...,
    with_alignments=True)``)."""

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        device = next(model.parameters()).device
        model.train()
        out = model.train_forward(batch, step_generator(hp, state.step,
                                                        device))
        losses = compute_loss(hp, out, batch, model)
        state.optimizer.zero_grad(set_to_none=False)
        losses["loss"].backward()
        grads = []
        for p in model.parameters():
            if p.grad is None:      # no path to the loss: a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        grad_norm = global_norm_clip(grads, 1.0)
        lr = learning_rate(hp, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["learning_rate"] = torch.tensor(lr, device=device)
        metrics["grad_norm"] = grad_norm.detach()
        if with_alignments:
            return metrics, (tuple(a[0].detach() for a in out.alignments),
                             out.outputs[0].detach())
        return metrics

    return train_step


def make_eval_step(hp: HParams) -> Callable[
        [TrainState, Batch],
        Tuple[Dict[str, torch.Tensor], TacotronOutput, TacotronOutput]]:
    """``eval_step(state, batch) -> (metrics, out_free, out_teacher)``: the
    reference's two-pass evaluation.  The free-running decode gives the
    main losses; the teacher-forced one, the reliable ``*_with_teacher``
    metrics.  The main key is ``code_loss`` or ``mel_loss``, by the model's
    kind (the JAX package's ``make_eval_step``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        model = state.model
        out_free = model.validation_forward(batch, False)
        losses_free = compute_loss(hp, out_free, batch, model)
        out_teacher = model.validation_forward(batch, True)
        losses_teacher = compute_loss(hp, out_teacher, batch, model)
        main_key = "code_loss" if "code_loss" in losses_free else "mel_loss"
        metrics = {
            main_key: losses_free[main_key],
            "done_loss": losses_free["done_loss"],
            "loss": losses_free["loss"],
            "loss_with_teacher": losses_teacher["loss"],
            f"{main_key}_with_teacher": losses_teacher[main_key],
            "done_loss_with_teacher": losses_teacher["done_loss"],
            "l2_regularization_loss": losses_free["l2_regularization_loss"],
        }
        return metrics, out_free, out_teacher

    return eval_step


def make_predict_step(hp: HParams) -> Callable[
        [nn.Module, Batch], Tuple[TacotronOutput, ...]]:
    """``predict_step(model, batch) -> outputs``, one per decode pass; the
    last is the prediction.  The first pass is INFERENCE (``model(batch)``:
    the fused kernels where their gates let it).  With
    ``hp.use_forced_alignment_mode`` a second pass decodes in VALIDATION,
    free-running over the batch's target steps, replaying the first pass's
    alignments, swapped to (B, T_dec, T_mem), in place of the attention
    mechanisms (the JAX package's ``make_predict_step``); the batch must
    then carry its target.  Past its stop step the first pass leaves what
    its path wrote there (the plain loop keeps decoding, the early-exit
    loop leaves zeros), and the replay takes those rows as they are."""

    @torch.no_grad()
    def predict_step(model: nn.Module, batch: Batch):
        out = model(batch)
        if not hp.use_forced_alignment_mode:
            return (out,)
        if batch.target is None:
            raise ValueError("use_forced_alignment_mode decodes the target's "
                             "steps again: the batch needs its target")
        teacher = tuple(a.transpose(1, 2) for a in out.alignments)
        return out, model.validation_forward(batch, False, teacher)

    return predict_step
