"""The whole batch-1 autoregressive decode loop as one CUDA kernel.

Replaces the JAX package's ``ops/fused_decode.py`` ``_kernel`` (Pallas,
reached through ``fused_decode``) in its batch-1 row mode, for source
attention kinds additive and forward.  Per step: prenet (its first product
rides the previous step's head) -> attention zoneout LSTM -> per-source
energies (with the location conv for forward sources) -> masked softmax
shifted by the row max -> forward recursion -> context -> merged output
projection + lstm1 -> lstm2 -> causal self-attention hops over KV caches ->
one output + stop + next-prenet head.  With ``early_stop`` the loop ends
once the stop logit is > 0 past ``min_iters``; rows after the exit read 0.

The softmax shift is the per-step row max, not the JAX kernel's static
bound ``sum |v|`` (with trained ``|v|`` every exp can flush to zero there).

``FusedDecodeParams`` carries the decoder's weights in the JAX layout
(``(in, out)`` matrices, (1, N) bias rows, gates i, g, f, o);
``merge_weights`` makes the one-time products (forget bias folded, outproj
premultiplied into lstm1, hop K|V|Q fused and Wo @ Wt, the head extended by
the feedback slice times the first prenet weight, the location conv times
the location dense) in the layout the kernel reads.  ``FusedDecodeMemory``
is the utterance: the attention keys, values and masks.
``fused_decode_reference`` is the plain PyTorch version of the kernel's
math; ``fused_decode`` runs it for CPU tensors only and launches the kernel
(``csrc/fused_decode.cu``) for CUDA tensors, raising on anything the kernel
does not take.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .rnn import fold_forget_bias, lstm_update

NEG_INF = -1e9
KIND_IDS = {"additive": 0, "forward": 2}
MAX_SOURCES = 4
MAX_PRENET = 4
MAX_HOPS = 4

# the kernel's StageClock slots (csrc), in order: SM cycles of block 0
# between consecutive grid barriers, summed over the call
DEC_STAGES = ("prenet", "att_lstm", "query", "energy", "softmax_ctx",
              "proj_lstm1", "lstm2", "hop_kvq", "hop_attn", "hop_out", "head",
              "setup")

# the run options of fused_decode / fused_decode_reference / prepare_decode:
# attention-LSTM and decoder-LSTM zoneout (inference mix), early exit
_RUN_DEFAULTS = dict(num_heads=2, zoneout_cell=0.0, zoneout_output=0.0,
                     dec_zoneout_cell=0.0, dec_zoneout_output=0.0,
                     early_stop=False, min_iters=10)

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
    # per forward source: the location conv kernel (K, F) and bias (F,),
    # the location dense (F, U) and the attention bias (U,); else None
    loc: Tuple[Optional[Tuple[Tensor, ...]], ...] = ()


class FusedDecodeMemory(NamedTuple):
    keys: Tuple[Tensor, ...]    # per source (1, T, U_i)
    values: Tuple[Tensor, ...]  # per source (1, T, C_i)
    masks: Tuple[Tensor, ...]   # per source (1, T) bool or {1, 0}


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


def merge_weights(params: FusedDecodeParams, *, num_mels: int,
                  outputs_per_step: int = 1, n_feed_frame: int = 1,
                  src_kinds=None, cumulative=None,
                  loc_kernel: int = 1) -> FusedDecodeWeights:
    """The one-time weight products of the serial chain."""
    ns = len(params.query)
    src_kinds = tuple(src_kinds or ("additive",) * ns)
    if any(k not in KIND_IDS for k in src_kinds):
        raise ValueError(f"source kinds {src_kinds}: only additive and "
                         "forward are ported")
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
        if k == 2:
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
    return FusedDecodeWeights(
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


def _memory_rows(w: FusedDecodeWeights, memory: FusedDecodeMemory):
    """Batch-1 memory as the kernel reads it: keys (T, sumU) with the
    constant fold added, values (T, Cctx), masks (ns, T), value widths."""
    if int(memory.keys[0].shape[0]) != 1:
        raise ValueError("the fused decode kernel serves batch 1 (the "
                         "batched row mode is not ported yet)")
    if len({int(k.shape[1]) for k in memory.keys}) != 1:
        raise ValueError("sources must share one memory length")
    keys = torch.cat([k[0] for k in memory.keys], 1) + w.key_fold
    values = torch.cat([v[0] for v in memory.values], 1).contiguous()
    mask = torch.cat([m.reshape(1, -1) for m in memory.masks], 0).float()
    return keys, values, mask, tuple(int(v.shape[2]) for v in memory.values)


def _options(options) -> dict:
    unknown = set(options) - set(_RUN_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown fused_decode options: {sorted(unknown)}")
    return dict(_RUN_DEFAULTS, **options)


def fused_decode_reference(weights: FusedDecodeWeights,
                           memory: FusedDecodeMemory, *, num_steps: int,
                           **options):
    """Plain PyTorch version of the kernel (the options of
    ``fused_decode``).  Returns (out (1, S, Cr), stop (1, S), aligns tuple
    of (1, S, T)) in float32."""
    o = _options(options)
    w = weights
    keys, values, mask, c_sizes = _memory_rows(w, memory)
    dev = keys.device
    S, T, cr = num_steps, keys.shape[0], w.cr
    ns = len(w.kinds)
    A = w.att_b.shape[0] // 4
    D = w.l2_b.shape[0] // 4
    u_off, c_off = [0], [0]
    for u in w.u_sizes:
        u_off.append(u_off[-1] + u)
    for c in c_sizes:
        c_off.append(c_off[-1] + c)
    K = w.loc_kernel
    pad = (K - 1) // 2
    zc_att, zo_att = o["zoneout_cell"], o["zoneout_output"]
    zc_dec, zo_dec = o["dec_zoneout_cell"], o["dec_zoneout_output"]
    num_heads = o["num_heads"]
    out = torch.zeros(S, cr + 1, device=dev)
    aligns = torch.zeros(S, ns, T, device=dev)
    caches = [(torch.zeros(S, D, device=dev), torch.zeros(S, D, device=dev))
              for _ in w.hops]
    hd = D // num_heads
    z = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    p0, ctx = w.p0_init, z(c_off[-1])
    h_att, c_att, h1, c1, h2, c2 = z(A), z(A), z(D), z(D), z(D), z(D)
    conv = torch.zeros(ns, T, device=dev)
    alpha = torch.zeros(ns, T, device=dev)
    alpha[:, 0] = 1.0
    valid = mask > 0.5
    for t in range(S):
        p = torch.relu(p0)
        for pw, pb in w.prenet:
            p = torch.relu(pw @ p + pb)
        c_att, h_att = lstm_update(
            w.att_w @ torch.cat([p, ctx, h_att]) + w.att_b, c_att, h_att,
            zc_att, zo_att)
        pq = w.q_w @ h_att
        rows, ctxs = [], []
        for i, kind in enumerate(w.kinds):
            us = slice(u_off[i], u_off[i + 1])
            pre = keys[:, us] + pq[us]
            if kind == 2:
                win = torch.nn.functional.pad(conv[i], (pad, K - 1 - pad))
                win = torch.stack([win[k:k + T] for k in range(K)], 1)
                pre = pre + win @ w.loc_w[:, us]
            e = torch.tanh(pre) @ w.v[us]
            e = torch.where(valid[i], e, torch.full_like(e, NEG_INF))
            ex = torch.exp(e - e.max())
            a = ex / ex.sum()
            if kind == 2:
                shifted = torch.nn.functional.pad(alpha[i, :-1], (1, 0))
                al = (0.5 * alpha[i] + 0.5 * shifted + 1e-7) * a
                al = al / al.sum()
                alpha[i] = al
                conv[i] = conv[i] + a if w.cumulative[i] else a
                a_out = al
            else:
                a_out = a
            rows.append(a_out)
            ctxs.append(a_out @ values[:, c_off[i]:c_off[i + 1]])
        aligns[t] = torch.stack(rows)
        ctx = torch.cat(ctxs)
        big = w.big_w @ torch.cat([h_att, ctx, h1]) + w.big_b
        c1, h1 = lstm_update(big[:4 * D], c1, h1, zc_dec, zo_dec)
        o1 = big[4 * D:] + h1
        c2, h2 = lstm_update(w.l2_w @ torch.cat([o1, h2]) + w.l2_b, c2, h2,
                             zc_dec, zo_dec)
        y = o1 + h2
        for (w_kvq, b_kvq, w_ot, b_ot), (kc, vc) in zip(w.hops, caches):
            kvq = w_kvq @ y + b_kvq
            kc[t], vc[t] = kvq[:D], kvq[D:2 * D]
            q = kvq[2 * D:]
            hctx = []
            for h in range(num_heads):
                sl = slice(h * hd, (h + 1) * hd)
                sc = kc[:t + 1, sl] @ q[sl] / math.sqrt(hd)
                hctx.append(torch.softmax(sc, dim=0) @ vc[:t + 1, sl])
            y = y + torch.tanh(w_ot @ torch.cat(hctx) + b_ot)
        row = w.head_w @ y + w.head_b
        out[t] = row[:cr + 1]
        p0 = row[cr + 1:]
        if o["early_stop"] and row[cr] > 0 and t > o["min_iters"]:
            break
    return _unpack(out, aligns, cr, ns)


def _unpack(out: Tensor, aligns: Tensor, cr: int, ns: int):
    return (out[None, :, :cr], out[None, :, cr],
            tuple(aligns[None, :, i] for i in range(ns)))


# --------------------------------------------------------------- the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int


class _DecArgs(ctypes.Structure):
    """Mirror of ``DecArgs`` in csrc/fused_decode.cu."""

    _fields_ = [
        ("S", _I), ("T", _I), ("ns", _I), ("cr", _I), ("P0", _I), ("A", _I),
        ("D", _I), ("n_pre", _I), ("n_hops", _I), ("n_heads", _I),
        ("K_loc", _I), ("early_stop", _I), ("min_iters", _I),
        ("kinds", _I * MAX_SOURCES), ("cumulative", _I * MAX_SOURCES),
        ("u_off", _I * (MAX_SOURCES + 1)), ("c_off", _I * (MAX_SOURCES + 1)),
        ("zc_att", ctypes.c_float), ("zo_att", ctypes.c_float),
        ("zc_dec", ctypes.c_float), ("zo_dec", ctypes.c_float),
        ("keys", _P), ("values", _P), ("mask", _P), ("loc_w", _P), ("v", _P),
        ("p0_init", _P),
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
        lib.fused_decode_launch.argtypes = [ctypes.POINTER(_DecArgs), _P]
        lib.fused_decode_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def prepare_decode(weights: FusedDecodeWeights, memory: FusedDecodeMemory,
                   *, num_steps: int, profile: bool = False,
                   **options) -> cuda_build.KernelLaunch:
    """Lay out the operands once (the options of ``fused_decode``); the
    returned launch runs the kernel and returns (out (S, Cr + 1), aligns
    (S, ns, T)).  With ``profile`` it also adds per-stage SM cycles to
    ``launch.stage_cycles`` (``DEC_STAGES``)."""
    o = _options(options)
    w = weights
    keys, values, mask, c_sizes = _memory_rows(w, memory)
    dev = keys.device
    ns = len(w.kinds)
    if ns > MAX_SOURCES or len(w.prenet) + 1 > MAX_PRENET \
            or len(w.hops) > MAX_HOPS:
        raise ValueError("more sources/prenet layers/hops than the kernel "
                         "takes")
    cr = w.cr
    T = int(keys.shape[0])
    A = int(w.att_b.shape[0]) // 4
    D = int(w.l2_b.shape[0]) // 4
    P0 = int(w.p0_init.shape[0])
    sumU, Cctx = sum(w.u_sizes), sum(c_sizes)
    if D % o["num_heads"]:
        raise ValueError("decoder units must divide over the heads")
    keep = []

    def use(t, shape, name):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected a float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    a = _DecArgs()
    a.S, a.T, a.ns, a.cr, a.P0, a.A, a.D = num_steps, T, ns, cr, P0, A, D
    a.n_pre, a.n_hops = len(w.prenet) + 1, len(w.hops)
    a.n_heads, a.K_loc = o["num_heads"], w.loc_kernel
    a.early_stop, a.min_iters = int(o["early_stop"]), int(o["min_iters"])
    for i in range(ns):
        a.kinds[i], a.cumulative[i] = w.kinds[i], int(w.cumulative[i])
    for i in range(ns + 1):
        a.u_off[i] = sum(w.u_sizes[:i])
        a.c_off[i] = sum(c_sizes[:i])
    a.zc_att, a.zo_att = o["zoneout_cell"], o["zoneout_output"]
    a.zc_dec, a.zo_dec = o["dec_zoneout_cell"], o["dec_zoneout_output"]
    a.keys = use(keys, (T, sumU), "keys")
    a.values = use(values, (T, Cctx), "values")
    a.mask = use(mask, (ns, T), "mask")
    a.loc_w = use(w.loc_w, (w.loc_kernel, sumU), "loc_w")
    a.v = use(w.v, (sumU,), "v")
    a.p0_init = use(w.p0_init, (P0,), "p0_init")
    width = P0
    for i, (pw, pb) in enumerate(w.prenet):
        n = int(pw.shape[0])
        a.pre_w[i] = use(pw, (n, width), f"prenet{i + 1}.w")
        a.pre_b[i] = use(pb, (n,), f"prenet{i + 1}.b")
        a.pre_in[i], a.pre_out[i] = width, n
        width = n
    a.att_w = use(w.att_w, (4 * A, width + Cctx + A), "att_w")
    a.att_b = use(w.att_b, (4 * A,), "att_b")
    a.q_w = use(w.q_w, (sumU, A), "q_w")
    a.big_w = use(w.big_w, (5 * D, A + Cctx + D), "big_w")
    a.big_b = use(w.big_b, (5 * D,), "big_b")
    a.l2_w = use(w.l2_w, (4 * D, 2 * D), "l2_w")
    a.l2_b = use(w.l2_b, (4 * D,), "l2_b")
    for i, (w_kvq, b_kvq, w_ot, b_ot) in enumerate(w.hops):
        a.kvq_w[i] = use(w_kvq, (3 * D, D), f"hop{i}.kvq_w")
        a.kvq_b[i] = use(b_kvq, (3 * D,), f"hop{i}.kvq_b")
        a.ot_w[i] = use(w_ot, (D, D), f"hop{i}.ot_w")
        a.ot_b[i] = use(b_ot, (D,), f"hop{i}.ot_b")
    a.head_w = use(w.head_w, (cr + 1 + P0, D), "head_w")
    a.head_b = use(w.head_b, (cr + 1 + P0,), "head_b")

    lib = _lib()
    out = torch.empty(num_steps, cr + 1, device=dev)
    aligns = torch.empty(num_steps, ns, T, device=dev)
    scratch = torch.empty(int(lib.fused_decode_scratch_floats(
        ctypes.byref(a))), device=dev)
    cycles = (torch.zeros(len(DEC_STAGES), dtype=torch.int64, device=dev)
              if profile else None)
    keep += [out, aligns, scratch, cycles]
    a.out, a.aligns, a.scratch = (out.data_ptr(), aligns.data_ptr(),
                                  scratch.data_ptr())
    a.stage_cycles = cycles.data_ptr() if profile else None
    return cuda_build.KernelLaunch(lib.fused_decode_launch, a, keep,
                                   (out, aligns), dev, fused_decode,
                                   stage_cycles=cycles)


def fused_decode(weights: FusedDecodeWeights, memory: FusedDecodeMemory, *,
                 num_steps: int, **options):
    """Run the whole inference loop at batch 1.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise).

    Options (defaults in ``_RUN_DEFAULTS``): num_heads, zoneout_cell and
    zoneout_output (attention LSTM), dec_zoneout_cell and
    dec_zoneout_output (decoder LSTMs), early_stop, min_iters.  Returns
    (out (1, S, Cr), stop (1, S), aligns tuple of (1, S, T)) in float32."""
    if not memory.keys[0].is_cuda:
        return fused_decode_reference(weights, memory, num_steps=num_steps,
                                      **options)
    out, aligns = prepare_decode(weights, memory, num_steps=num_steps,
                                 **options)()
    return _unpack(out, aligns, weights.cr, len(weights.kinds))


fused_decode.launches = 0
