"""Scaled dot-product multi-head attention with an incremental KV-cache step.

Counterpart of the JAX package's ``ops/attention_core.py``: four biased
projections (key, value, query, output), scores Q K^T / sqrt(head_dim),
softmax, then @ V.  The padding mask stays off, as in the reference (every
call site builds ``SelfAttention`` without it); the causal mask is a -1e9
fill.  ``MultiHeadAttention.step`` keeps (B, H, max_len, head_dim) caches,
writes each step's key and value into them in place (the decode loops never
go back to an earlier cache), and computes one query row per step: the same
math as column t of the full causal attention.  In training (the
full-sequence call only) the probabilities pass through dropout at
``drop_rate`` (keep 1 - rate, kept units scaled by 1 / (1 - rate), as flax's
``Dropout``), drawn from an explicit ``torch.Generator``; the returned
alignments are the probabilities before dropout.

With ``use_pallas`` (``hp.use_pallas_attention``), where no dropout is
active, the full-sequence call runs ``ops/pallas_attention``
``fused_self_attention`` and the step ``incremental_attention_step`` (CUDA
kernels; their plain versions on the CPU), and the alignments come back as
zeros, as the JAX package's gates do: the kernels never materialise the
probabilities.  The full-sequence kernel takes head widths up to 1024 and
the step any (each has a wide kernel past its tensor-core or register
templates); what a kernel refuses raises on the card, as its wrapper does.
A training call that would reach the full-sequence kernel (no dropout,
grad mode on, an input that needs a gradient) raises ``PallasTrainingError``
on every device: the kernel has no backward, and the JAX package cannot
differentiate its ``pallas_call`` either (no ``custom_vjp``, no transpose
rule), so the reference cannot train this configuration on any backend.

Model-wide bf16 (``ops/compute_dtype.py``): the projections, the scores,
the softmax and the context run in the module's ``dtype``; the scale is
1 / sqrt(head_dim) taken in that dtype (the JAX package's
``1 / jnp.sqrt(jnp.asarray(head_dim, q.dtype))``), the KV caches and the
zero alignments of the Pallas branches are in it too, and the kernels take
the bf16 q, k and v as they are (their bf16 instances).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .compute_dtype import Linear, softmax, weak
from .pallas_attention import fused_self_attention, incremental_attention_step

NEG_INF = -1e9

# which hparam sets each module's hop drop rate
DROP_RATE_HPARAMS = {"encoder": "self_attention_drop_rate",
                     "decoder": "decoder_self_attention_drop_rate"}


class PallasTrainingError(NotImplementedError):
    """Training with ``use_pallas_attention`` where a hop has no dropout."""

    def __init__(self, hparams):
        named = " and ".join(f"{h} = 0" for h in hparams)
        super().__init__(
            f"use_pallas_attention with {named} sends a training call to "
            "fused_self_attention, which has no backward: the JAX package "
            "cannot differentiate its pallas_call either (no custom_vjp, no "
            "transpose rule), so the reference trains this configuration on "
            "no backend.  Train with use_pallas_attention=false or a drop "
            "rate above 0; serve with the flag on.")


class AttentionCache(NamedTuple):
    key: torch.Tensor    # (B, H, max_len, head_dim)
    value: torch.Tensor  # (B, H, max_len, head_dim)


def positional_encoding(length: int, dim: int, device=None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal positions (length, dim): [sin | cos] halves, computed in
    float32 and returned in ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1 / sqrt(head_dim) with each step rounded to ``dtype``, as a Python
    float: a tensor of ``dtype`` times it is that dtype's product with the
    scale in that dtype, with no tensor made on the device."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim),
                                               dtype=dtype)))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep with probability 1 - rate and
    scale the kept units by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u >= rate, x / weak(1.0 - rate, x.dtype),
                       torch.zeros_like(x))


def _masked_softmax(scores: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return softmax(scores, -1)


class MultiHeadAttention(nn.Module):
    dtype = torch.float32

    def __init__(self, model_dim: int, num_heads: int,
                 use_subsequent_mask: bool = False, drop_rate: float = 0.0,
                 use_pallas: bool = False):
        super().__init__()
        assert model_dim % num_heads == 0
        self.drop_rate = drop_rate
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.use_subsequent_mask = use_subsequent_mask
        self.use_pallas = use_pallas
        self.key_projection = Linear(model_dim, model_dim)
        self.value_projection = Linear(model_dim, model_dim)
        self.query_projection = Linear(model_dim, model_dim)
        self.output_projection = Linear(model_dim, model_dim)

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, key, value, query, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """Full-sequence attention -> (out (B, Tq, D), align (B, H, Tq, Tk))."""
        k = self._split_heads(self.key_projection(key))
        v = self._split_heads(self.value_projection(value))
        q = self._split_heads(self.query_projection(query))
        B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]
        if self.use_pallas and not (training and self.drop_rate > 0.0):
            if training and torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v)):
                raise PallasTrainingError(
                    ("self_attention_drop_rate or "
                     "decoder_self_attention_drop_rate",))
            context = fused_self_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=self.use_subsequent_mask)
            return (self.output_projection(context.transpose(1, 2).reshape(
                        B, Tq, self.model_dim)),
                    torch.zeros(B, self.num_heads, Tq, Tk, dtype=q.dtype,
                                device=q.device))
        scores = (q @ k.transpose(-1, -2)) * attention_scale(
            self.head_dim, q.dtype)
        mask = None
        if self.use_subsequent_mask:
            mask = torch.ones(Tq, Tk, dtype=torch.bool,
                              device=q.device).tril()[None, None]
        probs = _masked_softmax(scores, mask)
        dropped = (dropout(probs, self.drop_rate, generator) if training
                   else probs)
        context = (dropped @ v).transpose(1, 2).reshape(B, Tq,
                                                        self.model_dim)
        return self.output_projection(context), probs

    def init_cache(self, batch: int, max_len: int, device=None
                   ) -> AttentionCache:
        shape = (batch, self.num_heads, max_len, self.head_dim)
        return AttentionCache(
            torch.zeros(shape, dtype=self.dtype, device=device),
            torch.zeros(shape, dtype=self.dtype, device=device))

    def step(self, x_t: torch.Tensor, t: int, cache: AttentionCache
             ) -> Tuple[torch.Tensor, AttentionCache, torch.Tensor]:
        """Causal attention for ``x_t`` (B, D) at position ``t`` ->
        (out_t (B, D), the cache with row t written in place,
        align_row (B, H, max_len))."""
        B = x_t.shape[0]
        shape = (B, self.num_heads, self.head_dim)
        k_t = self.key_projection(x_t).reshape(shape)
        v_t = self.value_projection(x_t).reshape(shape)
        q_t = self.query_projection(x_t).reshape(shape)
        key_cache, value_cache = cache
        key_cache[:, :, t] = k_t
        value_cache[:, :, t] = v_t
        max_len = key_cache.shape[2]
        if self.use_pallas:
            context = incremental_attention_step(q_t, key_cache, value_cache,
                                                 t)
            out = self.output_projection(context.reshape(B, self.model_dim))
            return out, cache, torch.zeros(B, self.num_heads, max_len,
                                           dtype=q_t.dtype, device=x_t.device)
        scores = torch.einsum("bhd,bhkd->bhk", q_t, key_cache) \
            * attention_scale(self.head_dim, q_t.dtype)
        valid = (torch.arange(max_len, device=x_t.device) <= t)[None, None]
        probs = _masked_softmax(scores, valid)
        context = torch.einsum("bhk,bhkd->bhd", probs, value_cache)
        out = self.output_projection(context.reshape(B, self.model_dim))
        return out, cache, probs


class SelfAttention(nn.Module):
    """K = V = Q = inputs."""

    def __init__(self, model_dim: int, num_heads: int,
                 use_subsequent_mask: bool = False, drop_rate: float = 0.0,
                 use_pallas: bool = False):
        super().__init__()
        self.attention = MultiHeadAttention(model_dim, num_heads,
                                            use_subsequent_mask, drop_rate,
                                            use_pallas)

    def forward(self, inputs, training: bool = False, generator=None):
        return self.attention(inputs, inputs, inputs, training, generator)

    def init_cache(self, batch: int, max_len: int, device=None):
        return self.attention.init_cache(batch, max_len, device)

    def step(self, x_t, t, cache):
        return self.attention.step(x_t, t, cache)
