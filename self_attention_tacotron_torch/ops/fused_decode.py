"""The whole autoregressive decode loop as one CUDA kernel.

Replaces the JAX package's ``ops/fused_decode.py`` ``_kernel`` (Pallas,
reached through ``fused_decode``) in all its modes: B = 1 and batched
rows (B >= 1, each source with its own memory length), source attention
kinds additive, location-sensitive and forward, and the per-utterance
speaker row of ``MultiSpeakerPreNet``.  Per step and row: prenet (its
first product rides the previous step's head; the speaker row is added
after that layer's ReLU) -> attention zoneout LSTM -> per-source energies
(with the location conv for location-sensitive and forward sources) ->
masked softmax shifted by the row max -> forward recursion (forward
sources) -> context -> merged output projection + lstm1 -> lstm2 ->
causal self-attention hops over per-row KV caches -> one output + stop +
next-prenet head.  With ``early_stop`` the loop ends once every row's stop
logit has been > 0 past ``min_iters``; a row that fired goes on decoding on
its own feedback until then, and steps after the exit read 0.  Source
alignments are returned for B = 1 only (zeros for B > 1, as in the JAX
package).

The softmax shift is the per-step row max, not the JAX kernel's static
bound ``sum |v|`` (with trained ``|v|`` every exp can flush to zero there).
At B = 1, when the alignment row is no wider than the context
(``context_from_alignments``), both the kernel and its plain version feed
the attention LSTM and the merged projection + lstm1 the alignment row in
place of the context, with the values folded into those products' weights
(``context_weights``): the kernel then has no context stage, and the
stage clock's ``softmax_ctx`` slot stays empty (the softmax is counted in
``proj_lstm1``).

``FusedDecodeParams`` carries the decoder's weights in the JAX layout
(``(in, out)`` matrices, (1, N) bias rows, gates i, g, f, o);
``merge_weights`` makes the one-time products (forget bias folded, outproj
premultiplied into lstm1, hop K|V|Q fused and Wo @ Wt, the head extended by
the feedback slice times the first prenet weight, the location conv times
the location dense) in the layout the kernel reads.  ``FusedDecodeMemory``
is the batch: per source the attention keys (B, T_i, U_i), values
(B, T_i, C_i) and masks (B, T_i).  ``fused_decode_reference`` is the plain
PyTorch version of the kernel's math; ``fused_decode`` runs it for CPU
tensors only and launches the kernel (``csrc/fused_decode.cu``) for CUDA
tensors, raising on anything the kernel does not take.
``unsupported_reason`` is the kernel's shared-memory plan as a
configuration gate (``smem_floats`` mirrors ``dec_smem`` in the source).

The bf16 storage mode (``merge_weights(..., compute_dtype="bfloat16")``,
the JAX package's ``fused_decode(compute_dtype=bf16)``): after the f32
merges every matrix is stored as bf16 and every bias, energy vector,
location product and the step-0 prenet row is rounded to bf16; the keys
(their fold added first) and values are stored as bf16.  Every product
rounds its input row to bf16 and sums in f32 (``_mm`` of the JAX kernel),
except the query projection and the location taps where the JAX kernel's
B = 1 row path multiplies in f32 (``round_attention_inputs``); the
softmax, the state, the KV caches and the outputs stay f32.  The fold of
the values into the products' weights is off in this mode: the JAX kernel
rounds the context to bf16 before its products, which the fold cannot
reproduce.  The kernel holds its weight slices as bf16 in shared memory
(one source, the weight type a template parameter).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .rnn import fold_forget_bias, lstm_update

NEG_INF = -1e9
KIND_IDS = {"additive": 0, "location_sensitive": 1, "forward": 2}
MAX_SOURCES = 4
MAX_PRENET = 4
MAX_HOPS = 4
H100_SMS = 132
SMEM_LIMIT = 232448   # bytes a block may opt in to on the H100
NT = 256              # threads a block (csrc/common.cuh)
CHUNK = 32            # cached steps a hop-attention item
GEMV_PART = (NT // 32) * 5 * 8   # the split products' scratch (csrc)

# the kernel's StageClock slots (csrc), in order: SM cycles of block 0
# between consecutive grid barriers, summed over the call
DEC_STAGES = ("prenet", "att_lstm", "query", "energy", "softmax_ctx",
              "proj_lstm1", "lstm2", "hop_kvq", "hop_attn", "hop_out", "head",
              "setup")

# the run options of fused_decode / fused_decode_reference / prepare_decode:
# attention-LSTM and decoder-LSTM zoneout (inference mix), early exit, the
# (B, P0) speaker row added after the first prenet layer's ReLU
_RUN_DEFAULTS = dict(num_heads=2, zoneout_cell=0.0, zoneout_output=0.0,
                     dec_zoneout_cell=0.0, dec_zoneout_output=0.0,
                     early_stop=False, min_iters=10, speaker_row=None)

Tensor = torch.Tensor


class FusedDecodeParams(NamedTuple):
    prenet: Tuple[Tuple[Tensor, Tensor], ...]  # (W (in, out), b (1, out))
    att_lstm: Tuple[Tensor, Tensor]            # (Zin, 4A), (1, 4A)
    query: Tuple[Tuple[Tensor, Tensor], ...]   # per source (Wq (A, U), v (U, 1))
    outproj: Tuple[Tensor, Tensor]             # (A + Cctx, D), (1, D)
    lstm1: Tuple[Tensor, Tensor]               # (2D, 4D), (1, 4D)
    lstm2: Tuple[Tensor, Tensor]
    hops: Tuple[Tuple[Tensor, ...], ...]       # (Wk,bk,Wv,bv,Wq,bq,Wo,bo,Wt,bt)
    head: Tuple[Tensor, Tensor]                # (D, Cr + 1), (1, Cr + 1)
    # per location-sensitive or forward source: the location conv kernel
    # (K, F) and bias (F,), the location dense (F, U) and the attention
    # bias (U,); None for additive sources
    loc: Tuple[Optional[Tuple[Tensor, ...]], ...] = ()


class FusedDecodeMemory(NamedTuple):
    keys: Tuple[Tensor, ...]    # per source (B, T_i, U_i)
    values: Tuple[Tensor, ...]  # per source (B, T_i, C_i)
    masks: Tuple[Tensor, ...]   # per source (B, T_i) bool or {1, 0}


class FusedDecodeWeights(NamedTuple):
    """Kernel-layout weights: every matrix is (out rows, in) so one row is
    one output column's weights."""

    p0_init: Tensor      # (P0,) step-0 first-prenet pre-activation (GO = 0)
    prenet: Tuple[Tuple[Tensor, Tensor], ...]  # layers 1..: (out, in), (out,)
    att_w: Tensor        # (4A, P + Cctx + A), gates i, g, f, o
    att_b: Tensor        # (4A,) forget folded
    q_w: Tensor          # (sumU, A) all sources' query projections
    v: Tensor            # (sumU,) energy vectors
    key_fold: Tensor     # (sumU,) attention bias + conv bias @ location dense
    loc_w: Tensor        # (K, sumU) conv @ location dense, 0 for additive
    big_w: Tensor        # (5D, A + Cctx + D): [lstm1 gates | proj] rows
    big_b: Tensor        # (5D,)
    l2_w: Tensor         # (4D, 2D)
    l2_b: Tensor         # (4D,)
    hops: Tuple[Tuple[Tensor, Tensor, Tensor, Tensor], ...]  # kvq (3D, D),
    #                      b (3D,), Wo@Wt (D, D), b (D,)
    head_w: Tensor       # (Cr + 1 + P0, D): [out | stop | feedback @ W0]
    head_b: Tensor
    kinds: Tuple[int, ...]
    cumulative: Tuple[bool, ...]
    u_sizes: Tuple[int, ...]
    cr: int              # output columns per step (num_mels * r)
    loc_kernel: int
    bf16: bool = False   # bf16 storage: matrices bf16, vectors rounded


def merge_weights(params: FusedDecodeParams, *, num_mels: int,
                  outputs_per_step: int = 1, n_feed_frame: int = 1,
                  src_kinds=None, cumulative=None, loc_kernel: int = 1,
                  compute_dtype: str = "float32") -> FusedDecodeWeights:
    """The one-time weight products of the serial chain, in f32; with
    ``compute_dtype="bfloat16"`` the storage rounding follows them."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: expected "
                         "float32 or bfloat16")
    ns = len(params.query)
    src_kinds = tuple(src_kinds or ("additive",) * ns)
    if any(k not in KIND_IDS for k in src_kinds):
        raise ValueError(f"source kinds {src_kinds}: expected one of "
                         f"{sorted(KIND_IDS)}")
    cumulative = tuple(bool(c) for c in (cumulative or (False,) * ns))
    cr = num_mels * outputs_per_step
    cf = num_mels * n_feed_frame
    D = params.lstm1[1].shape[1] // 4
    W0, b0 = params.prenet[0]
    dev = W0.device
    Wop, bop = params.outproj
    W1, b1 = params.lstm1[0], fold_forget_bias(params.lstm1[1])
    w_big = torch.cat([
        torch.cat([Wop @ W1[:D], Wop], 1),
        torch.cat([W1[D:], torch.zeros(D, D, device=dev)], 1)], 0)
    b_big = torch.cat([b1 + bop @ W1[:D], bop], 1)
    Wh, bh = params.head
    w_head = torch.cat([Wh, Wh[:, cr - cf:cr] @ W0], 1)
    b_head = torch.cat([bh, bh[:, cr - cf:cr] @ W0 + b0], 1)
    kinds = tuple(KIND_IDS[k] for k in src_kinds)
    u_sizes = tuple(int(wq.shape[1]) for wq, _ in params.query)
    K = int(loc_kernel)
    loc_w, fold = [], []
    for i, k in enumerate(kinds):
        if k != 0:
            conv_k, conv_b, w_loc, att_bias = params.loc[i]
            loc_w.append(conv_k @ w_loc)                    # (K, U)
            fold.append(att_bias + conv_b @ w_loc)          # (U,)
        else:
            loc_w.append(torch.zeros(K, u_sizes[i], device=dev))
            fold.append(torch.zeros(u_sizes[i], device=dev))
    hops = []
    for wk, bk, wv, bv, wq, bq, wo, bo, wt, bt in params.hops:
        hops.append((torch.cat([wk, wv, wq], 1).t().contiguous(),
                     torch.cat([bk, bv, bq], 1).reshape(-1),
                     (wo @ wt).t().contiguous(), (bo @ wt + bt).reshape(-1)))
    merged = FusedDecodeWeights(
        p0_init=b0.reshape(-1),
        prenet=tuple((w.t().contiguous(), b.reshape(-1))
                     for w, b in params.prenet[1:]),
        att_w=params.att_lstm[0].t().contiguous(),
        att_b=fold_forget_bias(params.att_lstm[1]).reshape(-1),
        q_w=torch.cat([wq for wq, _ in params.query], 1).t().contiguous(),
        v=torch.cat([v.reshape(-1) for _, v in params.query]),
        key_fold=torch.cat(fold), loc_w=torch.cat(loc_w, 1).contiguous(),
        big_w=w_big.t().contiguous(), big_b=b_big.reshape(-1),
        l2_w=params.lstm2[0].t().contiguous(),
        l2_b=fold_forget_bias(params.lstm2[1]).reshape(-1),
        hops=tuple(hops),
        head_w=w_head.t().contiguous(), head_b=b_head.reshape(-1),
        kinds=kinds, cumulative=cumulative, u_sizes=u_sizes, cr=cr,
        loc_kernel=K)
    return merged if compute_dtype == "float32" else _bf16_storage(merged)


def round_bf16(x: Tensor) -> Tensor:
    """x rounded to the nearest bf16 (ties to even), kept in f32; autograd
    rounds the gradient to bf16 on its way back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_storage(w: FusedDecodeWeights) -> FusedDecodeWeights:
    """The JAX kernel's ``w()`` casts after the merges: matrices as bf16
    tensors, the vectors rounded in f32 (the kernel reads them as f32);
    the key fold stays f32 (it joins the keys before their rounding)."""
    mat = lambda t: t.to(torch.bfloat16)  # noqa: E731
    return w._replace(
        p0_init=round_bf16(w.p0_init),
        prenet=tuple((mat(pw), round_bf16(pb)) for pw, pb in w.prenet),
        att_w=mat(w.att_w), att_b=round_bf16(w.att_b), q_w=mat(w.q_w),
        v=round_bf16(w.v), loc_w=round_bf16(w.loc_w), big_w=mat(w.big_w),
        big_b=round_bf16(w.big_b), l2_w=mat(w.l2_w),
        l2_b=round_bf16(w.l2_b),
        hops=tuple((mat(a), round_bf16(b), mat(c), round_bf16(d))
                   for a, b, c, d in w.hops),
        head_w=mat(w.head_w), head_b=round_bf16(w.head_b), bf16=True)


def _offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    out = [0]
    for s in sizes:
        out.append(out[-1] + int(s))
    return tuple(out)


def _memory(w: FusedDecodeWeights, memory: FusedDecodeMemory):
    """Per source: keys (B, T_i, U_i) with the constant fold added, values
    (B, T_i, C_i) (both bf16 in the bf16 mode) and boolean masks (B,
    T_i)."""
    B = int(memory.keys[0].shape[0])
    if any(int(t.shape[0]) != B for t in (*memory.keys, *memory.values,
                                          *memory.masks)):
        raise ValueError("every memory tensor must have the same batch")
    u_off = _offsets(w.u_sizes)
    keys = tuple(k + w.key_fold[u_off[i]:u_off[i + 1]]
                 for i, k in enumerate(memory.keys))
    values = memory.values
    if w.bf16:
        keys = tuple(k.to(torch.bfloat16) for k in keys)
        values = tuple(v.to(torch.bfloat16) for v in values)
    masks = tuple(m.reshape(B, -1) > 0.5 if m.dtype != torch.bool
                  else m.reshape(B, -1) for m in memory.masks)
    return keys, values, masks


def _options(options) -> dict:
    unknown = set(options) - set(_RUN_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown fused_decode options: {sorted(unknown)}")
    return dict(_RUN_DEFAULTS, **options)


def _windows(cv: Tensor, K: int) -> Tensor:
    """(B, T) conv input -> (B, T, K) windows: column k holds position
    t + k - pad, zero outside [0, T) (flax Conv SAME, cross-correlation)."""
    T = cv.shape[1]
    pad = (K - 1) // 2
    win = torch.nn.functional.pad(cv, (pad, K - 1 - pad))
    return torch.stack([win[:, k:k + T] for k in range(K)], 2)


def context_from_alignments(batch: int, t_sizes: Sequence[int],
                            c_sizes: Sequence[int],
                            bf16: bool = False) -> bool:
    """Whether the decode feeds the products the alignment row in place of
    the context: at B = 1, when the row (sum T_i) is no wider than the
    context (sum C_i), and not in the bf16 mode (whose products round the
    context itself to bf16).  The context enters only the products of the
    attention LSTM and of the merged projection + lstm1, linearly, so
    ``ctx @ W_ctx = alpha @ (V @ W_ctx)`` with V @ W_ctx folded into their
    weights once a call (``context_weights``); the kernel then skips the
    context stage and its grid barrier.  A batch would need a folded copy
    a row."""
    return not bf16 and batch == 1 and sum(t_sizes) <= sum(c_sizes)


def round_attention_inputs(w: FusedDecodeWeights, batch: int,
                           t_sizes: Sequence[int]) -> bool:
    """Whether the query projection and the location taps round their
    inputs to bf16: the bf16 mode outside the JAX kernel's B = 1 row path
    (one memory length for every source), which multiplies both in f32."""
    return w.bf16 and not (batch == 1 and len(set(t_sizes)) == 1)


def _mm(x: Tensor, weight: Tensor, rnd: bool) -> Tensor:
    """x @ weight^T for a kernel-layout (out, in) weight; with ``rnd`` the
    input row is rounded to bf16 first (the JAX kernel's ``_mm``)."""
    return (round_bf16(x) if rnd else x) @ weight.float().t()


def context_weights(w: FusedDecodeWeights, values: Sequence[Tensor],
                    c_sizes: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """att_w (4A, P + sum T_i + A) and big_w (5D, A + sum T_i + D) with
    each source's context columns replaced by their product with that
    source's values (B = 1): W[:, ctx_i] @ V_i^T, (rows, T_i)."""
    A = int(w.att_b.shape[0]) // 4
    c_off = _offsets(c_sizes)

    def fold(W, lead):
        parts = [W[:, :lead]]
        parts += [W[:, lead + c_off[i]:lead + c_off[i + 1]] @ v[0].t()
                  for i, v in enumerate(values)]
        parts.append(W[:, lead + c_off[-1]:])
        return torch.cat(parts, 1).contiguous()

    return fold(w.att_w, w.att_w.shape[1] - c_off[-1] - A), fold(w.big_w, A)


def fused_decode_reference(weights: FusedDecodeWeights,
                           memory: FusedDecodeMemory, *, num_steps: int,
                           **options):
    """Plain PyTorch version of the kernel (the options of
    ``fused_decode``).  Returns (out (B, S, Cr), stop (B, S), aligns tuple
    of (B, S, T_i), zeros unless B == 1) in float32."""
    o = _options(options)
    w = weights
    keys, values, masks = _memory(w, memory)
    dev = keys[0].device
    B, S, cr = int(keys[0].shape[0]), num_steps, w.cr
    A = w.att_b.shape[0] // 4
    D = w.l2_b.shape[0] // 4
    u_off = _offsets(w.u_sizes)
    K = w.loc_kernel
    zc_att, zo_att = o["zoneout_cell"], o["zoneout_output"]
    zc_dec, zo_dec = o["dec_zoneout_cell"], o["dec_zoneout_output"]
    num_heads = o["num_heads"]
    spk = o["speaker_row"]
    hd = D // num_heads
    t_sizes = [int(k.shape[1]) for k in keys]
    c_sizes = [int(v.shape[2]) for v in values]
    by_alpha = context_from_alignments(B, t_sizes, c_sizes, w.bf16)
    rq = round_attention_inputs(w, B, t_sizes)
    mm = lambda x, weight: _mm(x, weight, w.bf16)  # noqa: E731
    att_w, big_w = (context_weights(w, values, c_sizes) if by_alpha
                    else (w.att_w, w.big_w))
    out = torch.zeros(B, S, cr + 1, device=dev)
    aligns = [torch.zeros(B, S, k.shape[1], device=dev) for k in keys]
    caches = [(torch.zeros(B, S, D, device=dev),
               torch.zeros(B, S, D, device=dev)) for _ in w.hops]
    z = lambda n: torch.zeros(B, n, device=dev)  # noqa: E731
    p0 = w.p0_init.expand(B, -1)
    ctx = z(sum(t_sizes) if by_alpha else sum(c_sizes))
    h_att, c_att, h1, c1, h2, c2 = z(A), z(A), z(D), z(D), z(D), z(D)
    conv = [z(k.shape[1]) for k in keys]
    alpha = [torch.nn.functional.one_hot(
        torch.zeros(B, dtype=torch.long, device=dev), k.shape[1]).float()
        for k in keys]
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(S):
        p = torch.relu(p0)
        if spk is not None:
            p = p + spk
        for pw, pb in w.prenet:
            p = torch.relu(mm(p, pw) + pb)
        c_att, h_att = lstm_update(
            mm(torch.cat([p, ctx, h_att], 1), att_w) + w.att_b, c_att,
            h_att, zc_att, zo_att)
        pq = _mm(h_att, w.q_w, rq)
        ctxs = []
        for i, kind in enumerate(w.kinds):
            us = slice(u_off[i], u_off[i + 1])
            pre = keys[i].float() + pq[:, None, us]
            if kind != 0:
                win = _windows(conv[i], K)
                pre = pre + (round_bf16(win) if rq else win) @ w.loc_w[:, us]
            e = torch.tanh(pre) @ w.v[us]                    # (B, T_i)
            e = torch.where(masks[i], e, torch.full_like(e, NEG_INF))
            ex = torch.exp(e - e.amax(1, keepdim=True))
            a = ex / ex.sum(1, keepdim=True)
            if kind == 2:
                shifted = torch.nn.functional.pad(alpha[i][:, :-1], (1, 0))
                al = (0.5 * alpha[i] + 0.5 * shifted + 1e-7) * a
                al = al / al.sum(1, keepdim=True)
                alpha[i] = al
                a_out = al
            else:
                a_out = a
            if kind != 0:
                conv[i] = conv[i] + a if w.cumulative[i] else a
            aligns[i][:, t] = a_out
            ctxs.append(a_out if by_alpha else
                        torch.einsum("bt,btc->bc", a_out,
                                     values[i].float()))
        ctx = torch.cat(ctxs, 1)
        big = mm(torch.cat([h_att, ctx, h1], 1), big_w) + w.big_b
        c1, h1 = lstm_update(big[:, :4 * D], c1, h1, zc_dec, zo_dec)
        o1 = big[:, 4 * D:] + h1
        c2, h2 = lstm_update(mm(torch.cat([o1, h2], 1), w.l2_w) + w.l2_b,
                             c2, h2, zc_dec, zo_dec)
        y = o1 + h2
        for (w_kvq, b_kvq, w_ot, b_ot), (kc, vc) in zip(w.hops, caches):
            kvq = mm(y, w_kvq) + b_kvq
            kc[:, t], vc[:, t] = kvq[:, :D], kvq[:, D:2 * D]
            q = kvq[:, 2 * D:]
            hctx = []
            for h in range(num_heads):
                sl = slice(h * hd, (h + 1) * hd)
                sc = torch.einsum("bsd,bd->bs", kc[:, :t + 1, sl],
                                  q[:, sl]) / math.sqrt(hd)
                hctx.append(torch.einsum("bs,bsd->bd",
                                         torch.softmax(sc, dim=1),
                                         vc[:, :t + 1, sl]))
            y = y + torch.tanh(mm(torch.cat(hctx, 1), w_ot) + b_ot)
        row = mm(y, w.head_w) + w.head_b
        out[:, t] = row[:, :cr + 1]
        p0 = row[:, cr + 1:]
        if o["early_stop"] and t > o["min_iters"]:
            fired = fired | (row[:, cr] > 0)
            if bool(fired.all()):
                break
    return _unpack(out, aligns if B == 1 else [torch.zeros_like(a)
                                               for a in aligns], cr)


def _unpack(out: Tensor, aligns, cr: int):
    return out[..., :cr], out[..., cr], tuple(aligns)


# ------------------------------------------------- the shared-memory plan

def _items(n: int, nb: int) -> int:
    return (n + nb - 1) // nb


def smem_floats(w: FusedDecodeWeights, *, batch: int,
                t_sizes: Sequence[int], c_sizes: Sequence[int],
                num_steps: int, num_heads: int,
                blocks: int = H100_SMS) -> int:
    """Shared memory (floats) a block of the kernel needs with ``blocks``
    blocks: ``dec_smem`` in csrc/fused_decode.cu, which the CUDA tests hold
    this against.  It grows with the batch by the per-row state: the
    product inputs (B rows of the widest stage input), the query
    projections, four (B, sum T_i) attention rows and the LSTM cells.  In
    the bf16 mode each weight region holds two weights a float."""
    nb, B = blocks, int(batch)
    sumU, Cctx, sumT = sum(w.u_sizes), sum(c_sizes), sum(t_sizes)
    if context_from_alignments(B, t_sizes, c_sizes, w.bf16):
        Cctx = sumT
    A = int(w.att_b.shape[0]) // 4
    D = int(w.l2_b.shape[0]) // 4
    P0 = int(w.p0_init.shape[0])
    pre = [(int(pw.shape[0]), int(pw.shape[1])) for pw, _ in w.prenet]
    P = pre[-1][0] if pre else P0
    z_att, z_big = P + Cctx + A, A + Cctx + D
    nhead = w.cr + 1 + P0
    maxch = _items(num_steps, CHUNK)
    wf = (lambda n: (n + 1) // 2) if w.bf16 else (lambda n: n)  # noqa: E731
    f = sum(wf(_items(n, nb) * k) for n, k in pre)
    f += wf(_items(A, nb) * 4 * z_att) + wf(_items(sumU, nb) * A)
    f += wf(_items(D, nb) * 5 * z_big) + wf(_items(D, nb) * 8 * D)
    f += len(w.hops) * (wf(_items(3 * D, nb) * D) + wf(_items(D, nb) * D))
    f += wf(_items(nhead, nb) * D)
    f += sum(_items(n, nb) for n, _ in pre) + _items(A, nb) * 4
    f += _items(D, nb) * 9 + len(w.hops) * (_items(3 * D, nb)
                                            + _items(D, nb))
    f += _items(nhead, nb)
    f += B * (_items(A, nb) + 3 * _items(D, nb))       # c_att, c1, c2, y
    f += sumU + w.loc_kernel * sumU                      # v, loc
    f += 4 * B * sumT                             # mask, conv, alpha, erow
    xw = max(z_att, z_big, 2 * D, *(k for _, k in pre))
    f += B * xw + B * sumU                               # xin, pq
    f += CHUNK + 2 * B * num_heads * maxch + max(NT, D) + GEMV_PART + 32 + B
    return f


def unsupported_reason(w: FusedDecodeWeights, *, batch: int,
                       t_sizes: Sequence[int], c_sizes: Sequence[int],
                       num_steps: int, num_heads: int,
                       blocks: int = H100_SMS) -> Optional[str]:
    """Why the kernel cannot take this configuration, or None."""
    if len(w.kinds) > MAX_SOURCES:
        return f"more than {MAX_SOURCES} sources"
    if len(w.prenet) + 1 > MAX_PRENET:
        return f"more than {MAX_PRENET} prenet layers"
    if len(w.hops) > MAX_HOPS:
        return f"more than {MAX_HOPS} self-attention hops"
    need = 4 * smem_floats(w, batch=batch, t_sizes=t_sizes,
                           c_sizes=c_sizes, num_steps=num_steps,
                           num_heads=num_heads, blocks=blocks)
    if need > SMEM_LIMIT:
        return (f"batch {batch}: the kernel's shared-memory plan needs "
                f"{need} bytes a block (> {SMEM_LIMIT}; the per-row state "
                "grows with the batch)")
    return None


def max_batch(w: FusedDecodeWeights, *, t_sizes, c_sizes, num_steps: int,
              num_heads: int, blocks: int = H100_SMS) -> int:
    """The largest batch whose shared-memory plan fits a block."""
    B = 0
    while unsupported_reason(w, batch=B + 1, t_sizes=t_sizes,
                             c_sizes=c_sizes, num_steps=num_steps,
                             num_heads=num_heads, blocks=blocks) is None:
        B += 1
    return B


# --------------------------------------------------------------- the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _DecArgs(ctypes.Structure):
    """Mirror of ``DecArgs`` in csrc/fused_decode.cu."""

    _fields_ = [
        ("B", _I), ("S", _I), ("ns", _I), ("cr", _I), ("P0", _I), ("A", _I),
        ("D", _I), ("n_pre", _I), ("n_hops", _I), ("n_heads", _I),
        ("K_loc", _I), ("early_stop", _I), ("min_iters", _I),
        ("use_spk", _I), ("alpha_ctx", _I), ("bf16", _I), ("round_att", _I),
        ("kinds", _I * MAX_SOURCES), ("cumulative", _I * MAX_SOURCES),
        ("u_off", _I * (MAX_SOURCES + 1)), ("c_off", _I * (MAX_SOURCES + 1)),
        ("t_off", _I * (MAX_SOURCES + 1)),
        ("k_off", _L * (MAX_SOURCES + 1)), ("v_off", _L * (MAX_SOURCES + 1)),
        ("zc_att", ctypes.c_float), ("zo_att", ctypes.c_float),
        ("zc_dec", ctypes.c_float), ("zo_dec", ctypes.c_float),
        ("keys", _P), ("values", _P), ("mask", _P), ("loc_w", _P), ("v", _P),
        ("p0_init", _P), ("spk", _P),
        ("pre_w", _P * MAX_PRENET), ("pre_b", _P * MAX_PRENET),
        ("pre_in", _I * MAX_PRENET), ("pre_out", _I * MAX_PRENET),
        ("att_w", _P), ("att_b", _P), ("q_w", _P),
        ("big_w", _P), ("big_b", _P), ("l2_w", _P), ("l2_b", _P),
        ("kvq_w", _P * MAX_HOPS), ("kvq_b", _P * MAX_HOPS),
        ("ot_w", _P * MAX_HOPS), ("ot_b", _P * MAX_HOPS),
        ("head_w", _P), ("head_b", _P),
        ("out", _P), ("aligns", _P), ("scratch", _P),
        ("stage_cycles", _P),
    ]


def _lib():
    lib = cuda_build.load("fused_decode")
    if not getattr(lib, "_typed", False):
        lib.fused_decode_scratch_floats.argtypes = [ctypes.POINTER(_DecArgs)]
        lib.fused_decode_scratch_floats.restype = ctypes.c_longlong
        lib.fused_decode_smem_floats.argtypes = [ctypes.POINTER(_DecArgs),
                                                 _I]
        lib.fused_decode_smem_floats.restype = ctypes.c_longlong
        lib.fused_decode_launch.argtypes = [ctypes.POINTER(_DecArgs), _P]
        lib.fused_decode_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def prepare_decode(weights: FusedDecodeWeights, memory: FusedDecodeMemory,
                   *, num_steps: int, profile: bool = False,
                   **options) -> cuda_build.KernelLaunch:
    """Lay out the operands once (the options of ``fused_decode``); the
    returned launch runs the kernel and returns (out (B, S, Cr + 1),
    aligns (S, sum T_i) or None for B > 1).  With ``profile`` it also adds
    per-stage SM cycles to ``launch.stage_cycles`` (``DEC_STAGES``)."""
    o = _options(options)
    w = weights
    keys, values, masks = _memory(w, memory)
    dev = keys[0].device
    ns = len(w.kinds)
    B = int(keys[0].shape[0])
    t_sizes = tuple(int(k.shape[1]) for k in keys)
    c_sizes = tuple(int(v.shape[2]) for v in values)
    reason = unsupported_reason(w, batch=B, t_sizes=t_sizes,
                                c_sizes=c_sizes, num_steps=num_steps,
                                num_heads=o["num_heads"])
    if reason is not None:
        raise ValueError(f"the fused decode kernel does not take this: "
                         f"{reason}")
    if len(keys) != ns or len(values) != ns:
        raise ValueError(f"expected {ns} sources")
    cr = w.cr
    A = int(w.att_b.shape[0]) // 4
    D = int(w.l2_b.shape[0]) // 4
    P0 = int(w.p0_init.shape[0])
    sumU, Cctx, sumT = sum(w.u_sizes), sum(c_sizes), sum(t_sizes)
    if D % o["num_heads"]:
        raise ValueError("decoder units must divide over the heads")
    keep = []
    # the bf16 mode's matrices, keys and values are bf16 tensors
    wdt = torch.bfloat16 if w.bf16 else torch.float32

    def use(t, shape, name, dtype=torch.float32):
        if not t.is_cuda or t.dtype != dtype:
            raise ValueError(f"{name}: expected a {dtype} CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    for i in range(ns):
        use(keys[i], (B, t_sizes[i], w.u_sizes[i]), f"keys[{i}]", wdt)
        use(values[i], (B, t_sizes[i], c_sizes[i]), f"values[{i}]", wdt)
    folded = context_from_alignments(B, t_sizes, c_sizes, w.bf16)
    att_w, big_w = (context_weights(w, values, c_sizes) if folded
                    else (w.att_w, w.big_w))
    if folded:   # the products read the alignment row as their "context"
        Cctx = sumT
    a = _DecArgs()
    a.B, a.S, a.ns, a.cr, a.P0, a.A, a.D = B, num_steps, ns, cr, P0, A, D
    a.n_pre, a.n_hops = len(w.prenet) + 1, len(w.hops)
    a.n_heads, a.K_loc = o["num_heads"], w.loc_kernel
    a.early_stop, a.min_iters = int(o["early_stop"]), int(o["min_iters"])
    a.alpha_ctx = int(folded)
    a.bf16 = int(w.bf16)
    a.round_att = int(round_attention_inputs(w, B, t_sizes))
    u_off, c_off, t_off = (_offsets(w.u_sizes),
                           _offsets(t_sizes if folded else c_sizes),
                           _offsets(t_sizes))
    k_off = _offsets([B * t * u for t, u in zip(t_sizes, w.u_sizes)])
    v_off = _offsets([B * t * c for t, c in zip(t_sizes, c_sizes)])
    for i in range(ns):
        a.kinds[i], a.cumulative[i] = w.kinds[i], int(w.cumulative[i])
    for i in range(ns + 1):
        a.u_off[i], a.c_off[i], a.t_off[i] = u_off[i], c_off[i], t_off[i]
        a.k_off[i], a.v_off[i] = k_off[i], v_off[i]
    a.zc_att, a.zo_att = o["zoneout_cell"], o["zoneout_output"]
    a.zc_dec, a.zo_dec = o["dec_zoneout_cell"], o["dec_zoneout_output"]
    a.keys = use(torch.cat([k.reshape(-1) for k in keys]), (k_off[-1],),
                 "keys", wdt)
    a.values = use(torch.cat([v.reshape(-1) for v in values]), (v_off[-1],),
                   "values", wdt)
    a.mask = use(torch.cat(masks, 1).float(), (B, sumT), "mask")
    a.loc_w = use(w.loc_w, (w.loc_kernel, sumU), "loc_w")
    a.v = use(w.v, (sumU,), "v")
    a.p0_init = use(w.p0_init, (P0,), "p0_init")
    a.use_spk = int(o["speaker_row"] is not None)
    a.spk = (use(o["speaker_row"], (B, P0), "speaker_row") if a.use_spk
             else None)
    width = P0
    for i, (pw, pb) in enumerate(w.prenet):
        n = int(pw.shape[0])
        a.pre_w[i] = use(pw, (n, width), f"prenet{i + 1}.w", wdt)
        a.pre_b[i] = use(pb, (n,), f"prenet{i + 1}.b")
        a.pre_in[i], a.pre_out[i] = width, n
        width = n
    a.att_w = use(att_w, (4 * A, width + Cctx + A), "att_w", wdt)
    a.att_b = use(w.att_b, (4 * A,), "att_b")
    a.q_w = use(w.q_w, (sumU, A), "q_w", wdt)
    a.big_w = use(big_w, (5 * D, A + Cctx + D), "big_w", wdt)
    a.big_b = use(w.big_b, (5 * D,), "big_b")
    a.l2_w = use(w.l2_w, (4 * D, 2 * D), "l2_w", wdt)
    a.l2_b = use(w.l2_b, (4 * D,), "l2_b")
    for i, (w_kvq, b_kvq, w_ot, b_ot) in enumerate(w.hops):
        a.kvq_w[i] = use(w_kvq, (3 * D, D), f"hop{i}.kvq_w", wdt)
        a.kvq_b[i] = use(b_kvq, (3 * D,), f"hop{i}.kvq_b")
        a.ot_w[i] = use(w_ot, (D, D), f"hop{i}.ot_w", wdt)
        a.ot_b[i] = use(b_ot, (D,), f"hop{i}.ot_b")
    a.head_w = use(w.head_w, (cr + 1 + P0, D), "head_w", wdt)
    a.head_b = use(w.head_b, (cr + 1 + P0,), "head_b")

    lib = _lib()
    out = torch.empty(B, num_steps, cr + 1, device=dev)
    aligns = (torch.empty(num_steps, sumT, device=dev) if B == 1 else None)
    scratch = torch.empty(int(lib.fused_decode_scratch_floats(
        ctypes.byref(a))), device=dev)
    cycles = (torch.zeros(len(DEC_STAGES), dtype=torch.int64, device=dev)
              if profile else None)
    keep += [out, aligns, scratch, cycles]
    a.out, a.scratch = out.data_ptr(), scratch.data_ptr()
    a.aligns = aligns.data_ptr() if aligns is not None else None
    a.stage_cycles = cycles.data_ptr() if profile else None
    return cuda_build.KernelLaunch(lib.fused_decode_launch, a, keep,
                                   (out, aligns), dev, fused_decode,
                                   stage_cycles=cycles)


def kernel_smem_floats(weights: FusedDecodeWeights,
                       memory: FusedDecodeMemory, *, num_steps: int,
                       blocks: int = H100_SMS, **options) -> int:
    """The kernel's own shared-memory plan (``dec_smem``) for these
    operands, as the CUDA tests compare it with ``smem_floats``."""
    launch = prepare_decode(weights, memory, num_steps=num_steps, **options)
    return int(_lib().fused_decode_smem_floats(ctypes.byref(launch.args),
                                               blocks))


def fused_decode(weights: FusedDecodeWeights, memory: FusedDecodeMemory, *,
                 num_steps: int, **options):
    """Run the whole inference loop.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise).

    Options (defaults in ``_RUN_DEFAULTS``): num_heads, zoneout_cell and
    zoneout_output (attention LSTM), dec_zoneout_cell and
    dec_zoneout_output (decoder LSTMs), early_stop, min_iters, speaker_row
    ((B, P0) or None).  Returns (out (B, S, Cr), stop (B, S), aligns tuple
    of (B, S, T_i), zeros unless B == 1) in float32."""
    if not memory.keys[0].is_cuda:
        return fused_decode_reference(weights, memory, num_steps=num_steps,
                                      **options)
    out, aligns = prepare_decode(weights, memory, num_steps=num_steps,
                                 **options)()
    B = out.shape[0]
    t_off = _offsets([k.shape[1] for k in memory.keys])
    if aligns is not None:
        per_source = [aligns[None, :, t_off[i]:t_off[i + 1]]
                      for i in range(len(memory.keys))]
    else:
        per_source = [torch.zeros(B, num_steps, k.shape[1],
                                  device=out.device) for k in memory.keys]
    return _unpack(out, per_source, weights.cr)


fused_decode.launches = 0
