"""Masked losses, L2 regularization, gradient clipping and the learning-rate
schedule.

Counterpart of the JAX package's ``ops/losses.py``.  Reductions follow
``tf.losses`` SUM_BY_NONZERO_WEIGHTS: the masked sum over the number of
(broadcast) elements with a nonzero weight.  ``global_norm_clip`` is written
out rather than taken from ``torch.nn.utils.clip_grad_norm_``, which adds
1e-6 to the norm (optax and ``tf.clip_by_global_norm`` do not).  Under a
data axis (``ops/collectives.py``) each masked loss divides its local sum
by the valid-element count of the global batch, so that the ranks' losses
add up to the global batch's loss (a mean of per-rank means is wrong
whenever the ranks' valid counts differ).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

from .collectives import global_sum
from .compute_dtype import log_softmax


def _masked_mean(per_element: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
    if mask.dim() == per_element.dim() - 1:
        mask = mask[..., None]
    denom = global_sum(mask.sum() * (per_element.numel() / mask.numel()))
    return (per_element * mask).sum() / torch.clamp(denom, min=1.0)


def spec_loss(output: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, loss_type: str = "l1") -> torch.Tensor:
    """Masked L1 / MSE over frames (B, T, C) under a (B, T) mask."""
    if loss_type == "l1":
        per = (output - targets).abs()
    elif loss_type == "mse":
        per = (output - targets).square()
    else:
        raise ValueError(f"Unknown loss type: {loss_type}")
    return _masked_mean(per, mask)


codes_loss = spec_loss


def binary_loss(stop_token_logits: torch.Tensor, done: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked sigmoid cross-entropy of the stop token (logits (B, T, 1) or
    (B, T); done and mask (B, T))."""
    logits = stop_token_logits.reshape(done.shape)
    ce = (torch.clamp(logits, min=0.0) - logits * done
          + torch.log1p(torch.exp(-logits.abs())))
    return (ce * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


def classification_loss(logits: torch.Tensor, onehot_targets: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax cross-entropy over a class axis."""
    ce = -(onehot_targets * log_softmax(logits, -1)).sum(-1)
    return (ce * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


DEFAULT_L2_BLACKLIST: List[str] = [
    "embedding", "bias", "batch_normalization",
    "output_projection_wrapper/kernel", "lstm_cell",
    "output_and_stop_token_wrapper/dense/",
    "output_and_stop_token_wrapper/dense_1/", "stop_token_projection/kernel",
]


def l2_regularization_loss(named_params: Iterable[Tuple[str, torch.Tensor]],
                           weight: float,
                           blacklist: Sequence[str] = ()) -> torch.Tensor:
    """weight * sum of sum(v^2) / 2 over the parameters whose '/'-joined
    flax path (``utils/convert.py`` ``flax_param_paths``) contains no
    blacklist entry (case-insensitive substrings)."""
    total = None
    for path, leaf in named_params:
        name = path.lower()
        if any(b.lower() in name for b in blacklist):
            continue
        term = 0.5 * leaf.square().sum()
        total = term if total is None else total + term
    if total is None:
        return torch.zeros(())
    return weight * total


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def global_norm_clip(grads: Sequence[torch.Tensor], max_norm: float = 1.0):
    """Scale every gradient by max_norm / max(norm, max_norm) in place;
    returns the norm before clipping."""
    norm = global_norm(grads)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
    return norm


def noam_learning_rate(init_rate: float, global_step, step_factor: int = 1,
                       warmup_steps: float = 4000.0) -> float:
    """Noam warmup decay of update ``global_step`` (counted from 0)."""
    step = float(global_step * step_factor + 1)
    return init_rate * warmup_steps ** 0.5 * min(step * warmup_steps ** -1.5,
                                                 step ** -0.5)
