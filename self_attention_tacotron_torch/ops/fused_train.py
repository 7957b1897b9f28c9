"""The teacher-forced training trunk as two CUDA kernels (forward, backward).

Replaces the JAX package's ``ops/fused_train.py`` ``_fwd_kernel`` and
``_bwd_kernel`` (Pallas, reached through ``fused_teacher_scan``).  Per step
the trunk runs prenet (Dense, ReLU, dropout; a speaker row after layer 0
when given) -> attention zoneout LSTM over [p, ctx_prev, h_att] -> per
source: query, location window (K taps of the conv input), tanh energies,
masked softmax shifted by the row max, for forward sources the recursion
``(0.5 alpha + 0.5 shift(alpha) + 1e-7) a`` normalised, the context ->
projection -> two residual zoneout LSTMs.  Source kinds: additive (0),
location_sensitive (1), forward (2), with ``cumulative`` conv inputs.

* ``FusedTrainParams`` carries the trunk weights in the JAX layout
  ((in, out) matrices, (1, out) bias rows, gates i, g, f, o).
* ``fused_train_fwd_reference`` is the plain forward: it returns y, the
  per-step save rows (``save_layout``) and the alignment columns
  (``aux``: softmax, alignment, conv input per source) in the layout the
  forward kernel writes.
* ``fused_train_bwd_reference`` is the plain reverse-time VJP that reads
  those saves (the math of ``_bwd_kernel``); it is held against
  ``torch.autograd`` of the plain forward in the tests.
* ``fused_teacher_scan`` is the entry point.  On CPU tensors it runs the
  plain forward under ordinary autograd; on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward launches ``fused_train_fwd``
  (``csrc/fused_train_fwd.cu``) and whose backward launches
  ``fused_train_bwd`` (``csrc/fused_train_bwd.cu``), or raises.

Masks: dropout and zoneout come from ``ops/masks.py``, a counter-based hash
keyed on (seed, step, mask id, row, column) that ``csrc/masks.cuh`` repeats
bit for bit, so the kernels and the plain versions draw the same masks and
the backward regenerates the forward's.  ``deterministic`` turns dropout
off and zoneout into its expectation.

The bf16 storage mode (``compute_dtype="bfloat16"``, the JAX package's
``fused_teacher_scan(compute_dtype="bfloat16")``): the weights (with the
energy vectors), keys, values and the teacher are rounded to bf16 (``train_
operands``, by differentiable casts, so autograd rounds their gradients to
bf16 where the JAX package's VJP does); the location products and the
speaker row stay f32.  Every product rounds its input rows to bf16 and sums
in f32 (the JAX kernels' ``_mm`` / ``_mm_tB`` / ``_mm_tA``), except the
location terms and the values' gradient, which the JAX kernels keep in
f32, and the prenet bias gradients (f32 sums).  The backward reads the
save rows as the JAX kernel's bf16 save rows (the LSTM gates and cells
rounded as they are read; the query projections, which the JAX backward
recomputes in f32, are not) and contracts the weight gradients from a
bf16-rounded stash.  The save rows and the stash keep their f32 layout in
memory (bf16 values where the JAX kernels store bf16); the kernels hold
their resident weight slices in bf16 and multiply on bf16 tensor cores.

Not carried over from the TPU kernel, all TPU layout or tuning: the
128-lane padding of ``fused_teacher_scan``, the ``AUX_W`` rows with stored
conv windows, the (B*T, B) block indicator and ``_bcast`` (a block or warp
per utterance does the segment reductions here), ``dw_block``, ``ablate``
(wrong results by design), ``estimate_vmem_bytes`` (the gate uses
``smem_bytes``, this port's own shared-memory plan) and the float
``seed % 2^23`` carriage (the seed is a uint32 here).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_decode import round_bf16
from .masks import (MASK_ZC1, MASK_ZC2, MASK_ZC_ATT, MASK_ZO1, MASK_ZO2,
                    MASK_ZO_ATT, keep_mask)

Tensor = torch.Tensor
NEG_INF = -1e9
KIND_IDS = {"additive": 0, "location_sensitive": 1, "forward": 2}
MAX_SOURCES = 4
MAX_PRENET = 4
MAX_K = 32          # location-conv taps the gate admits (JAX default: 31)
MAX_BATCH = 64
# the kernels' target: one block per SM of an H100 (sm_90a), 227 KB of
# shared memory a block
H100_SMS = 132
SMEM_LIMIT = 232448
NT = 256
NWARPS = 8
# csrc/fused_train.cuh: attention items of US units / CS value columns,
# rows_mma's partial tiles, the 128 x 64 (x 32 deep) tile product
US, CS = 32, 64
ROW_PART = NWARPS * 128
TBM, TBN, TBK = 128, 64, 32
TILE_SMEM = TBM * (TBK + 4) + TBN * (TBK + 4)
# stages of the kernels' optional profile (block 0's SM cycles between
# grid barriers, each split into PARTS; the enums of csrc/fused_train.cuh)
FWD_STAGES = ("prenet", "att_lstm", "query", "energy", "context", "proj",
              "lstm1", "lstm2")
BWD_STAGES = ("setup", "lstm2", "dz2_lstm1", "dz1", "dzop", "d_w",
              "attention", "dq_att_lstm", "dzatt", "dW", "prenet")
PARTS = ("copy", "product", "epilogue", "wait")


class FusedTrainParams(NamedTuple):
    prenet: Tuple[Tuple[Tensor, Tensor], ...]  # per layer (W (in, out), b (1, out))
    att_lstm: Tuple[Tensor, Tensor]            # (P + sumC + A, 4A), (1, 4A)
    query: Tuple[Tuple[Tensor, Tensor], ...]   # per source (Wq (A, U), v (U, 1))
    outproj: Tuple[Tensor, Tensor]             # (A + sumC, D), (1, D)
    lstm1: Tuple[Tensor, Tensor]               # (2D, 4D), (1, 4D)
    lstm2: Tuple[Tensor, Tensor]


class TrainSpec(NamedTuple):
    batch: int
    num_steps: int
    cf: int                      # teacher width (num_mels * n_feed_frame)
    t_mem: int                   # memory length shared by the sources
    u_sizes: Tuple[int, ...]     # attention units per source
    c_sizes: Tuple[int, ...]     # value widths per source
    p_sizes: Tuple[int, ...]     # prenet layer widths
    p_dropout: Tuple[bool, ...]  # dropout after prenet layer i
    use_spk: bool                # a (B, P0) speaker row after layer 0
    src_kinds: Tuple[int, ...]   # KIND_IDS per source
    cumulative: Tuple[bool, ...]
    loc_kernel: int              # location conv taps K
    a_units: int
    d_units: int
    drop_rate: float
    zc_att: float
    zo_att: float
    zc_dec: float
    zo_dec: float
    deterministic: bool          # no dropout, zoneout by expectation
    compute_dtype: str = "float32"   # float32 | bfloat16 storage


def _fields(pairs):
    offsets, off = {}, 0
    for name, w in pairs:
        offsets[name] = (off, w)
        off += w
    return offsets, off


def save_layout(spec: TrainSpec):
    """(offsets {name: (offset, width)}, row width) of a save row: prenet
    activations p{i} (after ReLU) and outputs pd{i} (after dropout and the
    speaker row), then the trunk's per-step values."""
    A, D = spec.a_units, spec.d_units
    pairs = []
    for i, p in enumerate(spec.p_sizes):
        pairs += [(f"p{i}", p), (f"pd{i}", p)]
    pairs += [("gates_att", 4 * A), ("c_att", A), ("h_att", A),
              ("pq", sum(spec.u_sizes)), ("ctx", sum(spec.c_sizes)),
              ("proj", D), ("gates1", 4 * D), ("c1", D), ("h1", D),
              ("o1", D), ("gates2", 4 * D), ("c2", D), ("h2", D)]
    return _fields(pairs)


def stash_layout(spec: TrainSpec):
    """The backward's per-step cotangent rows, the right operands of the
    weight gradients and (``d_ctx``, the context's cotangent) of the
    values' gradient, contracted with the alignments after the loop."""
    A, D = spec.a_units, spec.d_units
    return _fields([("d_gatt", 4 * A), ("d_g1", 4 * D), ("d_g2", 4 * D),
                    ("d_proj", D), ("d_pq", sum(spec.u_sizes)),
                    ("d_ctx", sum(spec.c_sizes))])


def _step_masks(spec: TrainSpec, seed: int, t: int, device):
    """Zoneout keep masks of step t (None where off or deterministic)."""
    B, A, D = spec.batch, spec.a_units, spec.d_units
    m = {}
    for name, mid, z, n in (("zc_att", MASK_ZC_ATT, spec.zc_att, A),
                            ("zo_att", MASK_ZO_ATT, spec.zo_att, A),
                            ("zc1", MASK_ZC1, spec.zc_dec, D),
                            ("zo1", MASK_ZO1, spec.zo_dec, D),
                            ("zc2", MASK_ZC2, spec.zc_dec, D),
                            ("zo2", MASK_ZO2, spec.zo_dec, D)):
        m[name] = (None if spec.deterministic or z <= 0.0
                   else keep_mask(seed, t, mid, B, n, z, device))
    return m


def _dropout_on(spec: TrainSpec, li: int) -> bool:
    return (spec.drop_rate > 0.0 and not spec.deterministic
            and spec.p_dropout[li])


def _drop_scale(rate: float) -> Tensor:
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)


def _prenet_mask(spec: TrainSpec, seed: int, li: int, device) -> Tensor:
    """(S*B, P_li) dropout multipliers of layer li, rows t*B + b."""
    B, P = spec.batch, spec.p_sizes[li]
    keep = torch.cat([keep_mask(seed, t, li, B, P, spec.drop_rate, device)
                      for t in range(spec.num_steps)])
    return keep * _drop_scale(spec.drop_rate).to(device)


def _zone(new, prev, z, keep, det):
    if z <= 0.0:
        return new
    if det:
        return (1.0 - z) * new + z * prev
    return keep * new + (1.0 - keep) * prev


def _lstm_fwd(gates, c_prev, h_prev, zc, zo, keep_c, keep_h, det):
    i, g, f, o = gates.chunk(4, dim=1)
    c_raw = c_prev * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(g)
    h_raw = torch.tanh(c_raw) * torch.sigmoid(o)
    return (_zone(c_raw, c_prev, zc, keep_c, det),
            _zone(h_raw, h_prev, zo, keep_h, det))


def _lstm_bwd(gates, c_prev, d_h, d_c, zc, zo, keep_c, keep_h, det):
    """VJP of one zoneout LSTM step -> (d_gates, d_c_prev, d_h_prev), the
    last only through the zoneout pass-through."""
    i, g, f, o = gates.chunk(4, dim=1)
    si, tg = torch.sigmoid(i), torch.tanh(g)
    sf, so = torch.sigmoid(f + 1.0), torch.sigmoid(o)
    tc = torch.tanh(c_prev * sf + si * tg)
    if zo <= 0.0:
        d_h_raw, d_h_prev = d_h, torch.zeros_like(d_h)
    elif det:
        d_h_raw, d_h_prev = d_h * (1.0 - zo), d_h * zo
    else:
        d_h_raw, d_h_prev = d_h * keep_h, d_h * (1.0 - keep_h)
    d_o = d_h_raw * tc * so * (1.0 - so)
    d_c_from_h = d_h_raw * so * (1.0 - tc * tc)
    if zc <= 0.0:
        d_c_raw, d_c_prev = d_c + d_c_from_h, torch.zeros_like(d_c)
    elif det:
        d_c_raw, d_c_prev = d_c * (1.0 - zc) + d_c_from_h, d_c * zc
    else:
        d_c_raw, d_c_prev = d_c * keep_c + d_c_from_h, d_c * (1.0 - keep_c)
    d_c_prev = d_c_prev + d_c_raw * sf
    d_i = d_c_raw * tg * si * (1.0 - si)
    d_g = d_c_raw * si * (1.0 - tg * tg)
    d_f = d_c_raw * c_prev * sf * (1.0 - sf)
    return torch.cat([d_i, d_g, d_f, d_o], 1), d_c_prev, d_h_prev


def _windows(cv: Tensor, K: int) -> Tensor:
    """(B, T) conv input -> (B, T, K) SAME windows (pad (K-1)//2 left)."""
    T = cv.shape[1]
    pad = (K - 1) // 2
    padded = F.pad(cv, (pad, K - 1 - pad))
    return torch.stack([padded[:, k:k + T] for k in range(K)], 2)


def _window_adjoint(d_win: Tensor) -> Tensor:
    """(B, T, K) -> (B, T): the transpose of ``_windows``."""
    B, T, K = d_win.shape
    pad = (K - 1) // 2
    out = torch.zeros(B, T + K - 1, dtype=d_win.dtype, device=d_win.device)
    for k in range(K):
        out[:, k:k + T] += d_win[:, :, k]
    return out[:, pad:pad + T]


def _bf16(spec: TrainSpec) -> bool:
    return spec.compute_dtype == "bfloat16"


def _sources(spec: TrainSpec):
    u_off, c_off = [0], [0]
    for u in spec.u_sizes:
        u_off.append(u_off[-1] + u)
    for c in spec.c_sizes:
        c_off.append(c_off[-1] + c)
    return u_off, c_off


def _prev_rows(x: Tensor, B: int) -> Tensor:
    """Rows of the previous step (zeros at step 0) of (S*B, N) rows."""
    return torch.cat([torch.zeros_like(x[:B]), x[:-B]])


# ------------------------------------------------------------ plain version

def fused_train_fwd_reference(spec: TrainSpec, params: FusedTrainParams,
                              keys, values, masks, teacher_flat: Tensor,
                              seed: int, spk: Optional[Tensor], loc_ws):
    """Plain forward.  keys/values per source (B, T, U_i / C_i), masks
    (B, T) float, teacher_flat (S*B, cf) with rows t*B + b, loc_ws (K, U_i)
    or None.  Returns (y (S*B, D), save (S*B, W), aux (S, ns, 3, B, T):
    per source the softmax, the alignment and the conv input of the step).
    Differentiable.  In the bf16 mode the stored operands are rounded to
    bf16 first (``_storage``; a no-op on ``train_operands``' already
    rounded ones) and every product but the location term rounds its
    input rows to bf16."""
    rb = round_bf16 if _bf16(spec) else (lambda x: x)
    params, keys, values, teacher_flat = _storage(spec, params, keys, values,
                                                  teacher_flat)
    B, S, T = spec.batch, spec.num_steps, spec.t_mem
    A, D, K = spec.a_units, spec.d_units, spec.loc_kernel
    dev = teacher_flat.device
    u_off, c_off = _sources(spec)
    x = teacher_flat
    acts = []
    for li, (w, b) in enumerate(params.prenet):
        act = torch.relu(rb(x) @ w + b)
        pd = act * _prenet_mask(spec, seed, li, dev) if _dropout_on(
            spec, li) else act
        if spec.use_spk and li == 0:
            pd = pd + spk.repeat(S, 1)
        acts += [act, pd]
        x = pd
    p_steps = [a.reshape(S, B, -1) for a in acts]
    pd_last = x.reshape(S, B, -1)
    att_w, att_b = params.att_lstm
    q_w = torch.cat([wq for wq, _ in params.query], 1)
    vs = [v[:, 0] for _, v in params.query]
    z = lambda n: torch.zeros(B, n, device=dev)  # noqa: E731
    c_att, h_att, c1, h1, c2, h2 = z(A), z(A), z(D), z(D), z(D), z(D)
    ctx = z(c_off[-1])
    ns = len(spec.src_kinds)
    cv = [torch.zeros(B, T, device=dev) for _ in range(ns)]
    alpha = [F.one_hot(torch.zeros(B, dtype=torch.long, device=dev),
                       T).float() for _ in range(ns)]
    ys, rows, auxs = [], [], []
    for t in range(S):
        mk = _step_masks(spec, seed, t, dev)
        gates_att = rb(torch.cat([pd_last[t], ctx, h_att], 1)) @ att_w \
            + att_b
        c_att, h_att = _lstm_fwd(gates_att, c_att, h_att, spec.zc_att,
                                 spec.zo_att, mk["zc_att"], mk["zo_att"],
                                 spec.deterministic)
        pq = rb(h_att) @ q_w
        ctxs, aux_t = [], []
        for i, kind in enumerate(spec.src_kinds):
            pre = keys[i] + pq[:, None, u_off[i]:u_off[i + 1]]
            if kind != 0:
                pre = pre + _windows(cv[i], K) @ loc_ws[i]
            e = (torch.tanh(pre) * vs[i]).sum(-1)
            e = torch.where(masks[i] > 0.5, e, torch.full_like(e, NEG_INF))
            a = torch.softmax(e, -1)
            if kind == 2:
                sh = F.pad(alpha[i][:, :-1], (1, 0))
                zz = (0.5 * alpha[i] + 0.5 * sh + 1e-7) * a
                w = zz / zz.sum(-1, keepdim=True)
            else:
                w = a
            ctxs.append(torch.einsum("bt,btc->bc", w, values[i]))
            aux_t.append(torch.stack([a, w, cv[i]]))
            if kind != 0:
                cv[i] = cv[i] + a if spec.cumulative[i] else a
                alpha[i] = w
        ctx = torch.cat(ctxs, 1)
        proj = rb(torch.cat([h_att, ctx], 1)) @ params.outproj[0] \
            + params.outproj[1]
        gates1 = rb(torch.cat([proj, h1], 1)) @ params.lstm1[0] \
            + params.lstm1[1]
        c1, h1 = _lstm_fwd(gates1, c1, h1, spec.zc_dec, spec.zo_dec,
                           mk["zc1"], mk["zo1"], spec.deterministic)
        o1 = proj + h1
        gates2 = rb(torch.cat([o1, h2], 1)) @ params.lstm2[0] \
            + params.lstm2[1]
        c2, h2 = _lstm_fwd(gates2, c2, h2, spec.zc_dec, spec.zo_dec,
                           mk["zc2"], mk["zo2"], spec.deterministic)
        ys.append(o1 + h2)
        rows.append(torch.cat([p[t] for p in p_steps] + [
            gates_att, c_att, h_att, pq, ctx, proj, gates1, c1, h1, o1,
            gates2, c2, h2], 1))
        auxs.append(torch.stack(aux_t))
    return torch.cat(ys), torch.cat(rows), torch.stack(auxs)


def fused_train_bwd_reference(spec: TrainSpec, params: FusedTrainParams,
                              keys, values, masks, teacher_flat: Tensor,
                              seed: int, spk: Optional[Tensor], loc_ws,
                              g_y: Tensor, save: Tensor, aux: Tensor):
    """Plain reverse-time VJP from the forward's saves, in the order the
    backward kernel runs it.  Returns (d_params (FusedTrainParams layout),
    d_keys, d_values, d_spk (or None), d_loc (per source, None for
    additive)).  In the bf16 mode the gates and cells are read as bf16
    (the JAX kernel's bf16 save rows), the products round their inputs
    and the weight gradients contract bf16-rounded operands (its bf16
    stash); the location terms, the values' gradient and the prenet bias
    gradients stay f32.  The stored operands are rounded first, as in the
    forward; the gradients are the rounded operands' (autograd of the
    casts in ``fused_teacher_scan`` rounds them to bf16)."""
    rb = round_bf16 if _bf16(spec) else (lambda x: x)
    params, keys, values, teacher_flat = _storage(spec, params, keys, values,
                                                  teacher_flat)
    B, S, T = spec.batch, spec.num_steps, spec.t_mem
    A, D, K = spec.a_units, spec.d_units, spec.loc_kernel
    P = spec.p_sizes[-1]
    dev = save.device
    det = spec.deterministic
    off, _ = save_layout(spec)
    u_off, c_off = _sources(spec)
    sumC = c_off[-1]

    def get(rows, name):
        o, w = off[name]
        return rows[:, o:o + w]

    def saved(rows, name):   # a gate or cell row, as the bf16 save holds it
        return rb(get(rows, name))

    att_w = params.att_lstm[0]
    q_w = torch.cat([wq for wq, _ in params.query], 1)
    vs = [v[:, 0] for _, v in params.query]
    z = lambda n: torch.zeros(B, n, device=dev)  # noqa: E731
    d_c_att, d_h_att_c, d_c1, d_h1_c = z(A), z(A), z(D), z(D)
    d_c2, d_h2_c, d_ctx_c = z(D), z(D), z(sumC)
    ns = len(spec.src_kinds)
    dA = [torch.zeros(B, T, device=dev) for _ in range(ns)]
    dCV = [torch.zeros(B, T, device=dev) for _ in range(ns)]
    d_keys = [torch.zeros_like(k) for k in keys]
    d_values = [torch.zeros_like(v) for v in values]
    d_v = [torch.zeros(u, device=dev) for u in spec.u_sizes]
    d_loc = [torch.zeros(K, u, device=dev) if k != 0 else None
             for k, u in zip(spec.src_kinds, spec.u_sizes)]
    stash = [None] * S
    onehot = F.one_hot(torch.zeros(B, dtype=torch.long, device=dev),
                       T).float()
    for t in reversed(range(S)):
        mk = _step_masks(spec, seed, t, dev)
        rt = save[t * B:(t + 1) * B]
        rp = save[(t - 1) * B:t * B] if t > 0 else torch.zeros_like(rt)
        g = g_y[t * B:(t + 1) * B]
        dg2, d_c2, dh2_zo = _lstm_bwd(saved(rt, "gates2"), saved(rp, "c2"),
                                      g + d_h2_c, d_c2, spec.zc_dec,
                                      spec.zo_dec, mk["zc2"], mk["zo2"], det)
        dz2 = rb(dg2) @ params.lstm2[0].t()
        d_o1 = g + dz2[:, :D]
        d_h2_c = dh2_zo + dz2[:, D:]
        dg1, d_c1, dh1_zo = _lstm_bwd(saved(rt, "gates1"), saved(rp, "c1"),
                                      d_o1 + d_h1_c, d_c1, spec.zc_dec,
                                      spec.zo_dec, mk["zc1"], mk["zo1"], det)
        dz1 = rb(dg1) @ params.lstm1[0].t()
        d_proj = d_o1 + dz1[:, :D]
        d_h1_c = dh1_zo + dz1[:, D:]
        dzop = rb(d_proj) @ params.outproj[0].t()
        d_h_att_part = dzop[:, :A]
        d_ctx = dzop[:, A:] + d_ctx_c
        pq = get(rt, "pq")
        d_pqs = []
        for i, kind in enumerate(spec.src_kinds):
            a, w, cv = aux[t, i]
            ap = aux[t - 1, i, 1] if t > 0 else onehot
            dctx = d_ctx[:, c_off[i]:c_off[i + 1]]
            d_values[i] += w[:, :, None] * dctx[:, None, :]
            d_w = torch.einsum("bc,btc->bt", dctx, values[i])
            if kind == 2:
                d_alpha = d_w + dA[i]
                s = 0.5 * ap + 0.5 * F.pad(ap[:, :-1], (1, 0)) + 1e-7
                zsum = (s * a).sum(1, keepdim=True)
                sa = (d_alpha * w).sum(1, keepdim=True)
                d_z = (d_alpha - sa) / zsum
                d_s = d_z * a
                d_a = d_z * s + dCV[i]
                dA[i] = 0.5 * d_s + 0.5 * F.pad(d_s[:, 1:], (0, 1))
            elif kind == 1:
                d_a = d_w + dCV[i]
            else:
                d_a = d_w
            d_e = a * (d_a - (a * d_a).sum(1, keepdim=True))
            pre = keys[i] + pq[:, None, u_off[i]:u_off[i + 1]]
            if kind != 0:
                win = _windows(cv, K)
                pre = pre + win @ loc_ws[i]
            e = torch.tanh(pre)
            d_pre = d_e[:, :, None] * vs[i] * (1.0 - e * e)
            d_keys[i] += d_pre
            d_v[i] += (e * d_e[:, :, None]).sum((0, 1))
            d_pqs.append(d_pre.sum(1))
            if kind != 0:
                d_loc[i] += torch.einsum("btk,btu->ku", win, d_pre)
                d_cv = _window_adjoint(d_pre @ loc_ws[i].t())
                dCV[i] = d_cv + dCV[i] if spec.cumulative[i] else d_cv
        d_pq = torch.cat(d_pqs, 1)
        dgatt, d_c_att, dhatt_zo = _lstm_bwd(
            saved(rt, "gates_att"), saved(rp, "c_att"),
            d_h_att_part + rb(d_pq) @ q_w.t() + d_h_att_c, d_c_att,
            spec.zc_att,
            spec.zo_att, mk["zc_att"], mk["zo_att"], det)
        dzatt = rb(dgatt) @ att_w[P:].t()
        d_ctx_c = dzatt[:, :sumC]
        d_h_att_c = dhatt_zo + dzatt[:, sumC:]
        stash[t] = (dgatt, dg1, dg2, d_proj, d_pq)
    dgatt, dg1, dg2, d_proj, d_pq = (torch.cat(c) for c in zip(*stash))

    def dense(left, right, bias_f32=False):
        bias = (right if bias_f32 else rb(right)).sum(0, keepdim=True)
        return rb(left).t() @ rb(right), bias

    prev = lambda x: _prev_rows(x, B)  # noqa: E731
    h_att, ctx = get(save, "h_att"), get(save, "ctx")

    def pd(li):
        """Prenet layer li's output as the backward's weight gradients see
        it: the saved one in f32; in the bf16 mode rebuilt from the bf16
        save of the ReLU output, as the JAX backward does."""
        if not _bf16(spec):
            return get(save, f"pd{li}")
        out = rb(get(save, f"p{li}"))
        if _dropout_on(spec, li):
            out = out * _prenet_mask(spec, seed, li, dev)
        if spec.use_spk and li == 0:
            out = out + spk.repeat(S, 1)
        return out

    # lstm2's input o1 = proj + h1, in the bf16 mode from their bf16 saves
    o1 = (rb(get(save, "proj")) + rb(get(save, "h1")) if _bf16(spec)
          else get(save, "o1"))
    d_att = dense(torch.cat([pd(len(spec.p_sizes) - 1), prev(ctx),
                             prev(h_att)], 1), dgatt)
    d_l1 = dense(torch.cat([get(save, "proj"), prev(get(save, "h1"))], 1),
                 dg1)
    d_l2 = dense(torch.cat([o1, prev(get(save, "h2"))], 1), dg2)
    d_op = dense(torch.cat([h_att, ctx], 1), d_proj)
    d_q = rb(h_att).t() @ rb(d_pq)
    # prenet, deferred: d of the last prenet output, then layer by layer
    d_out = rb(dgatt) @ att_w[:P].t()
    d_prenet = [None] * len(spec.p_sizes)
    d_spk = None
    for li in reversed(range(len(spec.p_sizes))):
        if spec.use_spk and li == 0:
            d_spk = d_out.reshape(S, B, -1).sum(0)
        act = get(save, f"p{li}")
        d_pre = d_out * (act > 0).float()
        if _dropout_on(spec, li):   # the bf16 stash holds the mask in bf16
            d_pre = d_pre * rb(_prenet_mask(spec, seed, li, dev))
        left = teacher_flat if li == 0 else pd(li - 1)
        d_prenet[li] = dense(left, d_pre, bias_f32=True)
        if li > 0:
            d_out = rb(d_pre) @ params.prenet[li][0].t()
    d_query = tuple((d_q[:, u_off[i]:u_off[i + 1]], d_v[i][:, None])
                    for i in range(ns))
    d_params = FusedTrainParams(prenet=tuple(d_prenet), att_lstm=d_att,
                                query=d_query, outproj=d_op, lstm1=d_l1,
                                lstm2=d_l2)
    return d_params, tuple(d_keys), tuple(d_values), d_spk, tuple(d_loc)


# ------------------------------------------------------- the kernels' plan

def _items(n: int, nb: int) -> int:
    return (n + nb - 1) // nb


def _pad(n: int) -> int:
    """``tr_pad``: the least stride >= n that is 4 mod 32."""
    return ((n + 27) // 32) * 32 + 4


def _wpad(spec: TrainSpec, n: int) -> int:
    """``tr_wpad``: the row stride (floats) of a resident weight slice of n
    weights: ``_pad(n)``, or in the bf16 mode ``_pad`` of its 32-bit words
    (two weights a word)."""
    return _pad((n + 1) // 2) if _bf16(spec) else _pad(n)


def _plan(sizes) -> int:
    """Floats of consecutive regions, each starting 16-byte aligned."""
    o = 0
    for n in sizes:
        o = (o + n + 3) & ~3
    return o


def smem_bytes(spec: TrainSpec, blocks: int = H100_SMS) -> Tuple[int, int]:
    """Shared memory a block of the forward and of the backward kernel
    needs with ``blocks`` blocks (``fwd_smem`` / ``bwd_smem`` in
    csrc/fused_train.cuh, which the CUDA tests hold this against): the
    resident weight slices (rows of stride ``_pad``; above 16 rows a block
    serves one of two row groups and holds twice the columns), biases,
    energy and location vectors, the product's partial tiles, and one
    region that the staged rows, the tile product and the attention items
    share.  In the bf16 mode the weight slices hold two weights a float."""
    B, T, K = spec.batch, spec.t_mem, spec.loc_kernel
    A, D = spec.a_units, spec.d_units
    sumU, sumC = sum(spec.u_sizes), sum(spec.c_sizes)
    zatt = spec.p_sizes[-1] + sumC + A
    groups = 2 if B > 16 else 1   # tr_groups: the product stages' row groups
    it = lambda n: _items(n, blocks // groups)  # noqa: E731
    B = -(-B // groups)           # staged rows a block
    fwd_att = 2 * (-(-max(T + K + US, 4 * T + 2 * CS) // 4) * 4)  # 2 halves
    rows_f = B * _pad(max(zatt, A + sumC, 2 * D))
    wp = lambda n: _wpad(spec, n)  # noqa: E731
    fwd = _plan([it(A) * 4 * wp(zatt), it(sumU) * wp(A),
                 it(D) * wp(A + sumC), it(D) * 4 * wp(2 * D),
                 it(D) * 4 * wp(2 * D), it(A) * 4, it(D), it(D) * 4,
                 it(D) * 4, sumU, K * sumU, 3 * it(max(A, D)) * B, ROW_PART,
                 32, max(rows_f, TILE_SMEM), fwd_att])
    if 4 * _plan([fwd, rows_f]) <= SMEM_LIMIT:   # the second buffer, zp
        fwd = _plan([fwd, rows_f])
    bwd_att = 2 * (-(-(9 * T + K + US + T * (US + 4) + T * K
                       + 2 * (NWARPS // 2) * US) // 4) * 4)   # 2 halves
    items = spec.batch * sum(-(-u // US) for u in spec.u_sizes)
    iacc = -(-items // blocks) * (US + K * US)   # bwd_iacc_floats
    bwd = _plan([it(2 * D) * wp(4 * D), it(2 * D) * wp(4 * D),
                 it(A + sumC) * wp(D), it(A) * wp(sumU),
                 it(sumC + A) * wp(4 * A), sumU, K * sumU, ROW_PART, 32,
                 iacc,
                 max(B * _pad(max(4 * D, 4 * A, D, sumU)), bwd_att,
                     TILE_SMEM)])
    return 4 * fwd, 4 * bwd


def unsupported_reason(spec: TrainSpec,
                       blocks: int = H100_SMS) -> Optional[str]:
    """Why the kernels cannot take this configuration, or None."""
    if spec.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype {spec.compute_dtype!r} is not a storage dtype"
    if spec.batch > MAX_BATCH:
        return f"batch {spec.batch} > {MAX_BATCH} rows a step"
    if len(spec.src_kinds) > MAX_SOURCES:
        return f"more than {MAX_SOURCES} sources"
    if len(spec.p_sizes) > MAX_PRENET:
        return f"more than {MAX_PRENET} prenet layers"
    if spec.loc_kernel > MAX_K:
        return f"location conv width {spec.loc_kernel} > {MAX_K}"
    need = max(smem_bytes(spec, blocks))
    if need > SMEM_LIMIT:
        return (f"the kernels' shared-memory plan needs {need} bytes a "
                f"block (> {SMEM_LIMIT})")
    return None


# ---------------------------------------------------------------- launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in csrc/fused_train.cuh."""

    _fields_ = [
        *[(n, _I) for n in ("B", "S", "T", "cf", "ns", "n_pre", "A", "D", "K",
                            "use_spk", "deterministic", "save_w",
                            "stash_w", "bf16")],
        ("seed", ctypes.c_uint),
        ("kinds", _I * MAX_SOURCES), ("cumulative", _I * MAX_SOURCES),
        ("u_off", _I * (MAX_SOURCES + 1)), ("c_off", _I * (MAX_SOURCES + 1)),
        ("p_sizes", _I * MAX_PRENET), ("p_dropout", _I * MAX_PRENET),
        ("off_p", _I * MAX_PRENET), ("off_pd", _I * MAX_PRENET),
        *[(f"off_{n}", _I) for n in ("gatt", "catt", "hatt", "pq", "ctx",
                                     "proj", "g1", "c1", "h1", "o1", "g2",
                                     "c2", "h2", "dgatt", "dg1", "dg2",
                                     "dproj", "dpq", "dctxs")],
        *[(n, _F) for n in ("drop_rate", "drop_scale", "zc_att", "zo_att",
                            "zc_dec", "zo_dec")],
        ("keys", _P * MAX_SOURCES), ("values", _P * MAX_SOURCES),
        *[(n, _P) for n in ("mask", "loc_w", "v", "teacher", "spk")],
        ("pre_w", _P * MAX_PRENET), ("pre_b", _P * MAX_PRENET),
        *[(n, _P) for n in ("att_w", "att_b", "q_w", "op_w", "op_b", "l1_w",
                            "l1_b", "l2_w", "l2_b", "y", "save", "aux",
                            "g_y", "stash")],
        ("d_pre_w", _P * MAX_PRENET),
        *[(n, _P) for n in ("d_att", "d_q", "d_op", "d_l1", "d_l2")],
        ("d_keys", _P * MAX_SOURCES), ("d_values", _P * MAX_SOURCES),
        *[(n, _P) for n in ("d_v", "d_loc", "d_spk", "scratch",
                            "stage_cycles")],
    ]


_SAVE_ARG = {"gates_att": "gatt", "c_att": "catt", "h_att": "hatt",
             "pq": "pq", "ctx": "ctx", "proj": "proj", "gates1": "g1",
             "c1": "c1", "h1": "h1", "o1": "o1", "gates2": "g2", "c2": "c2",
             "h2": "h2"}
_STASH_ARG = {"d_gatt": "dgatt", "d_g1": "dg1", "d_g2": "dg2",
              "d_proj": "dproj", "d_pq": "dpq", "d_ctx": "dctxs"}


def _lib(name: str):
    lib = cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        for fn in ("scratch_floats", "smem_bytes", "launch"):
            f = getattr(lib, f"{name}_{fn}")
            if fn == "launch":
                f.argtypes = [ctypes.POINTER(_TrainArgs), _P]
                f.restype = ctypes.c_int
            else:
                f.argtypes = ([ctypes.POINTER(_TrainArgs)] if fn ==
                              "scratch_floats" else
                              [ctypes.POINTER(_TrainArgs), _I])
                f.restype = ctypes.c_longlong
        lib._typed = True
    return lib


class TrainOperands(NamedTuple):
    """The kernels' operands, flattened: weights in the JAX layout (biases
    flat), the query projections and energy vectors of all sources
    concatenated, the location products (K, sumU) with zero columns for
    additive sources, keys and values as (B*T, U_i / C_i), masks
    (ns, B, T), the teacher rows (S*B, cf) and the speaker row (B, P0)."""

    prenet: Tuple[Tuple[Tensor, Tensor], ...]
    att_w: Tensor
    att_b: Tensor
    q_w: Tensor
    v: Tensor
    op_w: Tensor
    op_b: Tensor
    l1_w: Tensor
    l1_b: Tensor
    l2_w: Tensor
    l2_b: Tensor
    loc_w: Tensor
    keys: Tuple[Tensor, ...]
    values: Tuple[Tensor, ...]
    mask: Tensor
    teacher: Tensor
    spk: Tensor


def _operand(t: Tensor, shape, name: str, keep: list) -> int:
    """The device pointer of a kernel operand, after checking its device,
    dtype, shape and contiguity; ``keep`` holds it alive."""
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    keep.append(t)
    return t.data_ptr()


def _args(spec: TrainSpec, ops: TrainOperands, seed: int, keep: list):
    """Fill the argument struct of both kernels; checks device, dtype,
    shape and contiguity of every operand."""
    B, S, T, K = spec.batch, spec.num_steps, spec.t_mem, spec.loc_kernel
    A, D = spec.a_units, spec.d_units
    ns = len(spec.src_kinds)
    sumU, sumC = sum(spec.u_sizes), sum(spec.c_sizes)
    reason = unsupported_reason(spec)
    if reason is not None:
        raise ValueError(f"fused training kernels: {reason}")

    def use(t, shape, name):
        return _operand(t, shape, name, keep)

    a = _TrainArgs()
    save_off, save_w = save_layout(spec)
    stash_off, stash_w = stash_layout(spec)
    a.B, a.S, a.T, a.cf, a.ns, a.n_pre = (B, S, T, spec.cf, ns,
                                          len(spec.p_sizes))
    a.A, a.D, a.K = A, D, K
    a.use_spk, a.deterministic = int(spec.use_spk), int(spec.deterministic)
    a.save_w, a.stash_w, a.seed = save_w, stash_w, int(seed) & 0xFFFFFFFF
    a.bf16 = int(_bf16(spec))
    u_off, c_off = _sources(spec)
    for i in range(ns):
        a.kinds[i], a.cumulative[i] = spec.src_kinds[i], int(
            spec.cumulative[i])
    for i in range(ns + 1):
        a.u_off[i], a.c_off[i] = u_off[i], c_off[i]
    for i, p in enumerate(spec.p_sizes):
        a.p_sizes[i], a.p_dropout[i] = p, int(spec.p_dropout[i])
        a.off_p[i], a.off_pd[i] = save_off[f"p{i}"][0], save_off[f"pd{i}"][0]
    for name, arg in _SAVE_ARG.items():
        setattr(a, f"off_{arg}", save_off[name][0])
    for name, arg in _STASH_ARG.items():
        setattr(a, f"off_{arg}", stash_off[name][0])
    a.drop_rate = spec.drop_rate
    a.drop_scale = (float(_drop_scale(spec.drop_rate))
                    if spec.drop_rate < 1.0 else 0.0)
    a.zc_att, a.zo_att = spec.zc_att, spec.zo_att
    a.zc_dec, a.zo_dec = spec.zc_dec, spec.zo_dec
    for i in range(ns):
        a.keys[i] = use(ops.keys[i], (B * T, spec.u_sizes[i]), f"keys{i}")
        a.values[i] = use(ops.values[i], (B * T, spec.c_sizes[i]),
                          f"values{i}")
    a.mask = use(ops.mask, (ns, B, T), "mask")
    a.loc_w = use(ops.loc_w, (K, sumU), "loc_w")
    a.v = use(ops.v, (sumU,), "v")
    a.teacher = use(ops.teacher, (S * B, spec.cf), "teacher")
    a.spk = use(ops.spk, (B, spec.p_sizes[0]), "speaker row")
    width = spec.cf
    for i, (w, b) in enumerate(ops.prenet):
        p = spec.p_sizes[i]
        a.pre_w[i] = use(w, (width, p), f"prenet{i}.w")
        a.pre_b[i] = use(b, (p,), f"prenet{i}.b")
        width = p
    zatt = width + sumC + A
    a.att_w = use(ops.att_w, (zatt, 4 * A), "att_w")
    a.att_b = use(ops.att_b, (4 * A,), "att_b")
    a.q_w = use(ops.q_w, (A, sumU), "q_w")
    a.op_w = use(ops.op_w, (A + sumC, D), "op_w")
    a.op_b = use(ops.op_b, (D,), "op_b")
    a.l1_w = use(ops.l1_w, (2 * D, 4 * D), "l1_w")
    a.l1_b = use(ops.l1_b, (4 * D,), "l1_b")
    a.l2_w = use(ops.l2_w, (2 * D, 4 * D), "l2_w")
    a.l2_b = use(ops.l2_b, (4 * D,), "l2_b")
    return a


def _profile(a, keep, stages, profile: bool, dev):
    """The profile's counts (``TrainClock`` in csrc/fused_train.cuh) when
    ``profile``, else None: block 0's cycles per (stage, part), then each
    block's attention-item cycles per source."""
    if not profile:
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cycles = torch.zeros(len(stages) * len(PARTS) + sms * MAX_SOURCES,
                         dtype=torch.int64, device=dev)
    keep.append(cycles)
    a.stage_cycles = cycles.data_ptr()
    return cycles


def profile_split(cycles: Sequence[int], stages: Sequence[str], ns: int,
                  ms: float, steps: int):
    """A profiled launch's counts -> (``{stage: {part: us a step}}``,
    ``{source: (mean, max, blocks)}``), block 0's cycles scaled to the
    kernel's measured ``ms``: each part's and each block's attention items'
    microseconds a step; the per-source figures over the blocks that ran
    items of that source."""
    c = [int(x) for x in cycles]
    n = len(stages) * len(PARTS)
    us = ms * 1e3 / max(sum(c[:n]), 1) / steps
    split = {st: {p: c[i * len(PARTS) + j] * us
                  for j, p in enumerate(PARTS)}
             for i, st in enumerate(stages)}
    per = c[n:]
    att = {}
    for src in range(ns):
        vals = [per[b * MAX_SOURCES + src] * us
                for b in range(len(per) // MAX_SOURCES)
                if per[b * MAX_SOURCES + src]]
        if vals:
            att[src] = (sum(vals) / len(vals), max(vals), len(vals))
    return split, att


def format_split(split, att) -> str:
    """``profile_split``'s result as one line of text."""
    stages = "; ".join(
        f"{st} {sum(parts.values()):.2f} (" + ", ".join(
            f"{p} {v:.2f}" for p, v in parts.items() if v) + ")"
        for st, parts in split.items() if sum(parts.values()))
    items = "; ".join(f"source {s} mean {m:.2f} max {x:.2f} over {n} blocks"
                      for s, (m, x, n) in att.items())
    return f"{stages}; attention items (us a step): {items}"


def prepare_train_fwd(spec: TrainSpec, ops: TrainOperands, seed: int,
                      profile: bool = False) -> cuda_build.KernelLaunch:
    """The forward launch; it returns (y (S*B, D), save, aux).  With
    ``profile`` it also adds per-stage SM cycles to
    ``launch.stage_cycles`` (``FWD_STAGES``)."""
    keep: list = []
    a = _args(spec, ops, seed, keep)
    lib = _lib("fused_train_fwd")
    dev = ops.teacher.device
    S, B = spec.num_steps, spec.batch
    y = torch.empty(S * B, spec.d_units, device=dev)
    save = torch.empty(S * B, a.save_w, device=dev)
    aux = torch.empty(S, len(spec.src_kinds), 3, B, spec.t_mem, device=dev)
    scratch = torch.empty(int(lib.fused_train_fwd_scratch_floats(
        ctypes.byref(a))), device=dev)
    keep += [y, save, aux, scratch]
    a.y, a.save, a.aux, a.scratch = (y.data_ptr(), save.data_ptr(),
                                     aux.data_ptr(), scratch.data_ptr())
    cycles = _profile(a, keep, FWD_STAGES, profile, dev)
    return cuda_build.KernelLaunch(lib.fused_train_fwd_launch, a, keep,
                                   (y, save, aux), dev, fused_train_fwd,
                                   stage_cycles=cycles)


def prepare_train_bwd(spec: TrainSpec, ops: TrainOperands, seed: int,
                      g_y: Tensor, save: Tensor, aux: Tensor,
                      profile: bool = False) -> cuda_build.KernelLaunch:
    """The backward launch; it returns the gradient buffers
    (``split_grads`` splits them).  ``profile``: as for the forward, with
    ``BWD_STAGES``."""
    keep: list = []
    a = _args(spec, ops, seed, keep)
    S, B, T, K = spec.num_steps, spec.batch, spec.t_mem, spec.loc_kernel
    A, D = spec.a_units, spec.d_units
    ns = len(spec.src_kinds)
    sumU, sumC = sum(spec.u_sizes), sum(spec.c_sizes)
    _, save_w = save_layout(spec)
    a.g_y = _operand(g_y, (S * B, D), "g_y", keep)
    a.save = _operand(save, (S * B, save_w), "save", keep)
    a.aux = _operand(aux, (S, ns, 3, B, T), "aux", keep)
    lib = _lib("fused_train_bwd")
    dev = ops.teacher.device
    e = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    width = spec.cf
    d_pre = []
    for i, p in enumerate(spec.p_sizes):
        d_pre.append(e(width + 1, p))
        a.d_pre_w[i] = d_pre[-1].data_ptr()
        width = p
    zatt = width + sumC + A
    d_att, d_q, d_op = e(zatt + 1, 4 * A), e(A, sumU), e(A + sumC + 1, D)
    d_l1, d_l2 = e(2 * D + 1, 4 * D), e(2 * D + 1, 4 * D)
    d_keys = [e(B * T, u) for u in spec.u_sizes]
    d_values = [e(B * T, c) for c in spec.c_sizes]
    d_v, d_loc = e(sumU), e(K, sumU)
    d_spk = torch.zeros(B, spec.p_sizes[0], device=dev)
    stash = e(S * B, a.stash_w)
    scratch = e(int(lib.fused_train_bwd_scratch_floats(ctypes.byref(a))))
    outs = (tuple(d_pre), d_att, d_q, d_op, d_l1, d_l2, tuple(d_keys),
            tuple(d_values), d_v, d_loc, d_spk)
    keep += [*d_pre, d_att, d_q, d_op, d_l1, d_l2, *d_keys, *d_values, d_v,
             d_loc, d_spk, stash, scratch]
    for name, t in (("d_att", d_att), ("d_q", d_q), ("d_op", d_op),
                    ("d_l1", d_l1), ("d_l2", d_l2), ("d_v", d_v),
                    ("d_loc", d_loc), ("d_spk", d_spk), ("stash", stash),
                    ("scratch", scratch)):
        setattr(a, name, t.data_ptr())
    for i in range(ns):
        a.d_keys[i], a.d_values[i] = (d_keys[i].data_ptr(),
                                      d_values[i].data_ptr())
    cycles = _profile(a, keep, BWD_STAGES, profile, dev)
    return cuda_build.KernelLaunch(lib.fused_train_bwd_launch, a, keep, outs,
                                   dev, fused_train_bwd, stage_cycles=cycles)


def fused_train_fwd(spec: TrainSpec, ops: TrainOperands, seed: int):
    """Launch the forward kernel: (y (S*B, D), save, aux)."""
    return prepare_train_fwd(spec, ops, seed)()


def fused_train_bwd(spec: TrainSpec, ops: TrainOperands, seed: int,
                    g_y: Tensor, save: Tensor, aux: Tensor):
    """Launch the backward kernel; returns the raw gradient buffers."""
    return prepare_train_bwd(spec, ops, seed, g_y, save, aux)()


fused_train_fwd.launches = 0
fused_train_bwd.launches = 0


def split_grads(spec: TrainSpec, raw):
    """The backward kernel's buffers -> (d_params in the JAX layout with
    flat biases, d_keys (B*T, U_i), d_values, d_v (sumU), d_loc (K, sumU),
    d_spk), matching ``TrainOperands``."""
    d_pre, d_att, d_q, d_op, d_l1, d_l2, d_keys, d_values, d_v, d_loc, \
        d_spk = raw
    wb = lambda g: (g[:-1], g[-1])  # noqa: E731
    return (tuple(wb(g) for g in d_pre), wb(d_att), d_q, wb(d_op), wb(d_l1),
            wb(d_l2), d_keys, d_values, d_v, d_loc, d_spk)


class _FusedTrainFn(torch.autograd.Function):
    """Forward kernel, then the backward kernel as its VJP.  Inputs: the
    flat ``TrainOperands`` tensors (``_flat``)."""

    @staticmethod
    def forward(ctx, spec, seed, *flat):
        ops = _unflat(spec, flat)
        y, save, aux = fused_train_fwd(spec, ops, seed)
        ctx.spec, ctx.seed = spec, seed
        ctx.save_for_backward(*flat, save, aux)
        ctx.mark_non_differentiable(aux)
        return y, aux

    @staticmethod
    def backward(ctx, g_y, _g_aux):
        *flat, save, aux = ctx.saved_tensors
        spec = ctx.spec
        ops = _unflat(spec, flat)
        (d_pre, (d_att_w, d_att_b), d_q, (d_op_w, d_op_b), (d_l1_w, d_l1_b),
         (d_l2_w, d_l2_b), d_keys, d_values, d_v, d_loc, d_spk) = split_grads(
            spec, fused_train_bwd(spec, ops, ctx.seed, g_y.contiguous(),
                                  save, aux))
        grads = TrainOperands(
            prenet=d_pre, att_w=d_att_w, att_b=d_att_b, q_w=d_q, v=d_v,
            op_w=d_op_w, op_b=d_op_b, l1_w=d_l1_w, l1_b=d_l1_b, l2_w=d_l2_w,
            l2_b=d_l2_b, loc_w=d_loc, keys=d_keys, values=d_values,
            mask=None, teacher=None,
            spk=d_spk if spec.use_spk else None)
        return (None, None, *_flat(grads))


class _PlainTrainFn(torch.autograd.Function):
    """The plain forward, then the plain reverse-time VJP as its backward:
    the CPU path of the bf16 mode, whose gradients follow the JAX
    kernels' rounding (autograd of the plain forward would not).  Inputs:
    the rounded params' leaves (``_param_leaves``), keys, values, masks,
    the teacher rows, the speaker row and the location products (None
    where absent)."""

    @staticmethod
    def forward(ctx, spec, seed, *flat):
        params, keys, values, masks, tf, spk, loc_ws = _unflat_plain(
            spec, flat)
        y, save, aux = fused_train_fwd_reference(
            spec, params, keys, values, masks, tf, seed, spk, loc_ws)
        ctx.spec, ctx.seed = spec, seed
        ctx.save_for_backward(*[t for t in flat if t is not None], save,
                              aux)
        ctx.present = [t is not None for t in flat]
        ctx.mark_non_differentiable(aux)
        return y, aux

    @staticmethod
    def backward(ctx, g_y, _g_aux):
        it = iter(ctx.saved_tensors)
        flat = [next(it) if p else None for p in ctx.present]
        save, aux = next(it), next(it)
        spec = ctx.spec
        params, keys, values, masks, tf, spk, loc_ws = _unflat_plain(
            spec, flat)
        d_params, d_keys, d_values, d_spk, d_loc = fused_train_bwd_reference(
            spec, params, keys, values, masks, tf, ctx.seed, spk, loc_ws,
            g_y.contiguous(), save, aux)
        ns = len(spec.src_kinds)
        grads = (_param_leaves(d_params) + list(d_keys) + list(d_values)
                 + [None] * (ns + 1) + [d_spk] + list(d_loc))
        return (None, None, *grads)


def _param_leaves(params: FusedTrainParams):
    out = []
    for w, b in params.prenet:
        out += [w, b]
    out += list(params.att_lstm)
    for wq, v in params.query:
        out += [wq, v]
    out += [*params.outproj, *params.lstm1, *params.lstm2]
    return out


def _unflat_plain(spec: TrainSpec, flat):
    n_pre, ns = len(spec.p_sizes), len(spec.src_kinds)
    it = iter(flat)
    prenet = tuple((next(it), next(it)) for _ in range(n_pre))
    att = (next(it), next(it))
    query = tuple((next(it), next(it)) for _ in range(ns))
    outproj, l1, l2 = [(next(it), next(it)) for _ in range(3)]
    params = FusedTrainParams(prenet, att, query, outproj, l1, l2)
    keys = tuple(next(it) for _ in range(ns))
    values = tuple(next(it) for _ in range(ns))
    masks = tuple(next(it) for _ in range(ns))
    tf, spk = next(it), next(it)
    loc_ws = tuple(next(it) for _ in range(ns))
    return params, keys, values, masks, tf, spk, loc_ws


def _flat(ops: TrainOperands):
    out = []
    for w, b in ops.prenet:
        out += [w, b]
    out += [ops.att_w, ops.att_b, ops.q_w, ops.v, ops.op_w, ops.op_b,
            ops.l1_w, ops.l1_b, ops.l2_w, ops.l2_b, ops.loc_w]
    out += [*ops.keys, *ops.values, ops.mask, ops.teacher, ops.spk]
    return out


def _unflat(spec: TrainSpec, flat) -> TrainOperands:
    n_pre, ns = len(spec.p_sizes), len(spec.src_kinds)
    it = iter(flat)
    prenet = tuple((next(it), next(it)) for _ in range(n_pre))
    rest = [next(it) for _ in range(11)]
    keys = tuple(next(it) for _ in range(ns))
    values = tuple(next(it) for _ in range(ns))
    mask, teacher, spk = next(it), next(it), next(it)
    return TrainOperands(prenet, *rest, keys=keys, values=values, mask=mask,
                         teacher=teacher, spk=spk)


def _storage(spec: TrainSpec, params: FusedTrainParams, keys, values,
             teacher_flat: Tensor):
    """The bf16 mode's rounding of the stored operands (identity in f32):
    params, keys, values and the teacher, by differentiable casts."""
    if not _bf16(spec):
        return params, keys, values, teacher_flat
    rb = round_bf16
    params = FusedTrainParams(
        prenet=tuple((rb(w), rb(b)) for w, b in params.prenet),
        att_lstm=tuple(map(rb, params.att_lstm)),
        query=tuple((rb(wq), rb(v)) for wq, v in params.query),
        outproj=tuple(map(rb, params.outproj)),
        lstm1=tuple(map(rb, params.lstm1)),
        lstm2=tuple(map(rb, params.lstm2)))
    return (params, tuple(map(rb, keys)), tuple(map(rb, values)),
            rb(teacher_flat))


def train_operands(spec: TrainSpec, params: FusedTrainParams, keys, values,
                   masks, teacher_flat: Tensor, speaker_row, loc_ws
                   ) -> TrainOperands:
    """The kernels' flat operands, made with differentiable torch ops from
    the JAX-layout inputs (autograd carries their gradients back); in the
    bf16 mode the stored operands are rounded (``_storage``)."""
    params, keys, values, teacher_flat = _storage(spec, params, keys, values,
                                                  teacher_flat)
    B, T, K = spec.batch, spec.t_mem, spec.loc_kernel
    dev = teacher_flat.device
    loc = [lw if lw is not None else torch.zeros(K, u, device=dev)
           for lw, u in zip(loc_ws, spec.u_sizes)]
    spk = (speaker_row.contiguous() if speaker_row is not None
           else torch.zeros(B, spec.p_sizes[0], device=dev))
    return TrainOperands(
        prenet=tuple((w.contiguous(), b.reshape(-1).contiguous())
                     for w, b in params.prenet),
        att_w=params.att_lstm[0].contiguous(),
        att_b=params.att_lstm[1].reshape(-1).contiguous(),
        q_w=torch.cat([wq for wq, _ in params.query], 1).contiguous(),
        v=torch.cat([v.reshape(-1) for _, v in params.query]).contiguous(),
        op_w=params.outproj[0].contiguous(),
        op_b=params.outproj[1].reshape(-1).contiguous(),
        l1_w=params.lstm1[0].contiguous(),
        l1_b=params.lstm1[1].reshape(-1).contiguous(),
        l2_w=params.lstm2[0].contiguous(),
        l2_b=params.lstm2[1].reshape(-1).contiguous(),
        loc_w=torch.cat(loc, 1).contiguous(),
        keys=tuple(k.reshape(B * T, -1).contiguous() for k in keys),
        values=tuple(v.reshape(B * T, -1).contiguous() for v in values),
        mask=torch.stack([m.float() for m in masks]).contiguous(),
        teacher=teacher_flat.contiguous(), spk=spk)


def make_spec(params: FusedTrainParams, keys, values, teacher_xs: Tensor, *,
              drop_rate: float, zc_att: float, zo_att: float, zc_dec: float,
              zo_dec: float, deterministic: bool, p_dropout=None,
              use_spk: bool = False, src_kinds=None, cumulative=None,
              loc_kernel: int = 1, compute_dtype: str = "float32"
              ) -> TrainSpec:
    B, S, cf = teacher_xs.shape
    ns = len(keys)
    p_sizes = tuple(int(b.shape[-1]) for _, b in params.prenet)
    kinds = tuple(KIND_IDS[k] for k in (src_kinds or ("additive",) * ns))
    return TrainSpec(
        batch=int(B), num_steps=int(S), cf=int(cf),
        t_mem=int(keys[0].shape[1]),
        u_sizes=tuple(int(k.shape[2]) for k in keys),
        c_sizes=tuple(int(v.shape[2]) for v in values), p_sizes=p_sizes,
        p_dropout=tuple(bool(f) for f in (p_dropout or (True,) * len(
            p_sizes))),
        use_spk=bool(use_spk), src_kinds=kinds,
        cumulative=tuple(bool(c) for c in (cumulative or (False,) * ns)),
        loc_kernel=int(loc_kernel),
        a_units=int(params.att_lstm[1].shape[-1]) // 4,
        d_units=int(params.lstm1[1].shape[-1]) // 4,
        drop_rate=float(drop_rate), zc_att=float(zc_att),
        zo_att=float(zo_att), zc_dec=float(zc_dec), zo_dec=float(zo_dec),
        deterministic=bool(deterministic), compute_dtype=str(compute_dtype))


def fused_teacher_scan(params: FusedTrainParams, keys, values, masks,
                       teacher_xs: Tensor, seed: int, *, drop_rate: float,
                       zc_att: float, zo_att: float, zc_dec: float,
                       zo_dec: float, deterministic: bool, p_dropout=None,
                       speaker_row: Optional[Tensor] = None, src_kinds=None,
                       cumulative=None, loc_kernel: int = 1, loc_ws=None,
                       compute_dtype: str = "float32"):
    """Run the teacher-forced trunk: keys/values per source (B, T, U/C),
    masks (B, T), teacher_xs (B, S, cf), seed an int.  Returns (y
    (B, S, D), alignments per source (B, S, T), not differentiable).
    Differentiable w.r.t. params, keys, values, speaker_row and loc_ws.
    CPU tensors run the plain version, under autograd in f32 and with the
    plain reverse-time VJP in the bf16 mode; CUDA tensors the two kernels
    (or raise).  ``compute_dtype="bfloat16"``: the bf16 storage mode."""
    spec = make_spec(params, keys, values, teacher_xs, drop_rate=drop_rate,
                     zc_att=zc_att, zo_att=zo_att, zc_dec=zc_dec,
                     zo_dec=zo_dec, deterministic=deterministic,
                     p_dropout=p_dropout, use_spk=speaker_row is not None,
                     src_kinds=src_kinds, cumulative=cumulative,
                     loc_kernel=loc_kernel, compute_dtype=compute_dtype)
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: expected "
                         "float32 or bfloat16")
    B, S = spec.batch, spec.num_steps
    loc_ws = tuple(loc_ws or (None,) * len(keys))
    teacher_flat = teacher_xs.transpose(0, 1).reshape(S * B, spec.cf)
    if not teacher_xs.is_cuda and _bf16(spec):
        rp, rk, rv, rt = _storage(spec, params, keys, values, teacher_flat)
        y, aux = _PlainTrainFn.apply(
            spec, int(seed), *_param_leaves(rp), *rk, *rv,
            *[m.float() for m in masks], rt, speaker_row, *loc_ws)
    elif not teacher_xs.is_cuda:
        y, _, aux = fused_train_fwd_reference(
            spec, params, keys, values, [m.float() for m in masks],
            teacher_flat, seed, speaker_row, loc_ws)
    else:
        ops = train_operands(spec, params, keys, values, masks, teacher_flat,
                             speaker_row, loc_ws)
        y, aux = _FusedTrainFn.apply(spec, int(seed), *_flat(ops))
    out = y.reshape(S, B, spec.d_units).transpose(0, 1)
    aligns = tuple(aux[:, i, 1].detach().transpose(0, 1)
                   for i in range(len(spec.src_kinds)))
    return out, aligns
