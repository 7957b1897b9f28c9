"""The whole batch-1 inference encoder as one CUDA kernel.

Replaces the JAX package's ``ops/fused_encoder.py`` ``_kernel`` (Pallas,
reached through ``fused_encode``): prenet -> K=1..16 conv bank with batch
norm folded in -> width-2 max pool -> two width-3 projection convs ->
residual -> highway layers -> bidirectional zoneout LSTM (both directions
in one loop, the backward one walking the per-row length-reversed sequence)
-> self-attention projection and hops.  ``csrc/fused_encoder.cu`` runs it
as two launches a call: the trunk up to the LSTM's input products (one
cooperative launch, products on the tensor cores, the bank read width by
width without its zero blocks) and the recurrence with the hop (a cluster
of 8 blocks holding the recurrent weights in registers, 16 past 128 units
a direction).  Widths that are not multiples of 4 take the kernel's
instance with 4-byte copies (``vector_copies``); the layers' weights reach
it through a table in device memory, so their counts are not bounded.

``FusedEncoderParams`` holds the merged weights in the layout the kernel
reads (``(in, out)`` matrices, (1, N) bias rows, highway [H | T] columns
interleaved, LSTM gates i, g, f, o with the +1 forget bias folded and the
recurrent weight transposed); ``models/encoders.py`` builds it once.
``fused_encode_reference`` is the plain PyTorch version of the kernel's
math; ``fused_encode`` runs it for CPU tensors only and launches the kernel
(``csrc/fused_encoder.cu``) for CUDA tensors, raising on anything the
kernel does not take: what ``unsupported_reason`` names (an LSTM wider than
its largest cluster holds, shared-memory plans past 227 KB, and the two
conditions the JAX kernel's shapes need too; any source length, the hop
streaming past what shared memory holds).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .rnn import lstm_update

NEG_INF = -1e9

# the kernel's profile slots (csrc ``EncClock``): block 0's SM cycles of each
# stage, split into copying operands in, the product and epilogue (a
# recurrent step's dot products and cell) and the barrier wait; slot
# stage * len(ENC_PARTS) + part, summed over the call
ENC_STAGES = ("prenet", "bank", "proj", "highway", "lstm_input", "lstm_steps",
              "self_attention")
ENC_PARTS = ("load", "product", "wait")
# csrc constants of the shared-memory plan (``smem_bytes``)
MT, NI, DENSE_C, BANK_C, PROJ1_C = 64, 8, 256, 128, 256
RED_FLOATS, RNN_GX_STEPS, NWARPS = 512, 32, 8
UNITS_A_BLOCK = 32   # the recurrent cluster: 32 units a block,
MAX_HALF = 256       # 4 blocks a direction up to 128 units, 8 up to 256
SMEM_LIMIT = 232448  # bytes a block may opt in to on the H100 (227 KB)


Tensor = torch.Tensor


class FusedEncoderParams(NamedTuple):
    prenet: Tuple[Tuple[Tensor, Tensor], ...]   # (W (in, out), b (1, out))
    w_bank: Tuple[Tensor, Tensor]               # (K*E, K*C), (1, K*C)
    w_proj1: Tuple[Tensor, Tensor]              # (3*K*C, P1), (1, P1)
    w_proj2: Tuple[Tensor, Tensor]              # (3*P1, P2), (1, P2)
    w_adjust: Optional[Tuple[Tensor, Tensor]]   # (P2, half) or None
    highway: Tuple[Tuple[Tensor, Tensor], ...]  # (W, 2W), (1, 2W) columns
    #                                             H_0, T_0, H_1, T_1, ...
    lstm: Tuple[Tensor, Tensor, Tensor]         # fw, bw: Wx (2, W, 4H),
    #                                             Wh^T (2, 4H, H), b (2, 4H)
    #                                             forget folded
    sa_proj: Tuple[Tensor, Tensor]              # (2H, SA), (1, SA)
    hops: Tuple[Tuple[Tensor, ...], ...]        # (W_kvq, b_kvq, W_ot, b_ot)


def _windows(x: Tensor, K: int, pad_left: int) -> Tensor:
    """(T, K*E) im2col rows: block k of row t is x[t + k - pad_left]
    (zero outside [0, T))."""
    T = x.shape[0]
    padded = torch.nn.functional.pad(x, (0, 0, pad_left, K - 1 - pad_left))
    return torch.cat([padded[k:k + T] for k in range(K)], dim=1)


def fused_encode_reference(params: FusedEncoderParams, x: Tensor, length, *,
                           max_filter_width: int, conv_channels: int,
                           half: int, sa_units: int, num_heads: int,
                           zoneout_cell: float = 0.0,
                           zoneout_output: float = 0.0
                           ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel's math.  ``x`` is the (1, T, E)
    embedded source; returns (lstm_out (1, T, 2*half), sa_out (1, T, SA))."""
    assert x.shape[0] == 1, "the fused encoder is the batch-1 serving path"
    T = x.shape[1]
    L = int(length)
    K = max_filter_width
    h = x[0].float()
    for w, b in params.prenet:
        h = torch.relu(h @ w + b)
    banked = torch.relu(_windows(h, K, (K - 1) // 2 if K > 1 else 0)
                        @ params.w_bank[0] + params.w_bank[1])
    nxt = torch.cat([banked[1:], torch.full_like(banked[:1], NEG_INF)])
    pooled = torch.maximum(banked, nxt)
    p1 = torch.relu(_windows(pooled, 3, 1) @ params.w_proj1[0]
                    + params.w_proj1[1])
    hw = _windows(p1, 3, 1) @ params.w_proj2[0] + params.w_proj2[1] + h
    if params.w_adjust is not None:
        hw = hw @ params.w_adjust[0] + params.w_adjust[1]
    for w, b in params.highway:
        ht = hw @ w + b
        tt = torch.sigmoid(ht[:, 1::2])
        hw = torch.relu(ht[:, 0::2]) * tt + hw * (1.0 - tt)

    wx, whT, b_lstm = params.lstm
    ys = [torch.zeros(T, half, device=x.device) for _ in range(2)]
    carry = [[torch.zeros(1, half, device=x.device)] * 2 for _ in range(2)]
    for t in range(L):  # carries freeze and outputs stay zero past L
        for d, row in ((0, t), (1, L - 1 - t)):
            c, hh = carry[d]
            gates = hw[row:row + 1] @ wx[d] + hh @ whT[d].t() + b_lstm[d]
            carry[d] = list(lstm_update(gates, c, hh, zoneout_cell,
                                        zoneout_output))
            ys[d][row] = carry[d][1][0]
    lstm_out = torch.cat(ys, dim=1)

    sa = lstm_out @ params.sa_proj[0] + params.sa_proj[1]
    hd = sa_units // num_heads
    for w_kvq, b_kvq, w_ot, b_ot in params.hops:
        kvq = sa @ w_kvq + b_kvq
        ctxs = []
        for hh in range(num_heads):
            k = kvq[:, hh * hd:(hh + 1) * hd]
            v = kvq[:, sa_units + hh * hd:sa_units + (hh + 1) * hd]
            q = kvq[:, 2 * sa_units + hh * hd:2 * sa_units + (hh + 1) * hd]
            p = torch.softmax(q @ k.t() / math.sqrt(hd), dim=1)
            ctxs.append(p @ v)
        sa = sa + torch.tanh(torch.cat(ctxs, dim=1) @ w_ot + b_ot)
    return lstm_out[None], sa[None]


# --------------------------------------------------------------- the kernel

_P = ctypes.c_void_p


class _EncArgs(ctypes.Structure):
    """Mirror of ``EncArgs`` in csrc/fused_encoder.cu."""

    _fields_ = [
        ("x", _P), ("T", ctypes.c_int), ("L", ctypes.c_int),
        ("E_in", ctypes.c_int), ("n_prenet", ctypes.c_int),
        ("pre_max", ctypes.c_int),
        ("pre_w", _P), ("pre_b", _P), ("pre_out", _P),
        ("bank_w", _P), ("bank_b", _P), ("K", ctypes.c_int),
        ("C", ctypes.c_int),
        ("p1_w", _P), ("p1_b", _P), ("P1", ctypes.c_int),
        ("p2_w", _P), ("p2_b", _P), ("P2", ctypes.c_int),
        ("adj_w", _P), ("adj_b", _P),
        ("n_highway", ctypes.c_int),
        ("hw_w", _P), ("hw_b", _P),
        ("W", ctypes.c_int), ("H", ctypes.c_int),
        ("lstm_wx", _P * 2), ("lstm_whT", _P * 2), ("lstm_b", _P * 2),
        ("zc", ctypes.c_float), ("zo", ctypes.c_float),
        ("sa_w", _P), ("sa_b", _P), ("SA", ctypes.c_int),
        ("n_hops", ctypes.c_int), ("n_heads", ctypes.c_int),
        ("kvq_w", _P), ("kvq_b", _P), ("ot_w", _P), ("ot_b", _P),
        ("lstm_out", _P), ("sa_out", _P), ("scratch", _P),
        ("stage_cycles", _P), ("v4", ctypes.c_int),
    ]


def _round8(n: int) -> int:
    return (n + 7) & ~7


def _slab_ld(cp: int) -> int:
    return ((cp + 31) & ~31) + 4


def _dense(K: int) -> int:
    cw = min(_round8(K), DENSE_C)
    return MT * _slab_ld(cw) + cw * NI + NI


def smem_bytes(T: int, E_in: int, prenet: Tuple[int, ...], K: int, C: int,
               P1: int, P2: int, W: int, H: int, SA: int,
               heads: int) -> Tuple[int, int]:
    """Shared memory a block of the trunk and of the recurrent cluster
    needs (``trunk_smem_floats`` / ``rnn_smem_floats`` in
    csrc/fused_encoder.cu, which the CUDA tests hold this against): the
    largest item's slab (64 rows, or 64 + taps - 1 for a convolution, at a
    stride of 4 mod 32; the first projection also holds its raw rows
    before the pool) and weight tile (8 columns), its bias entries (the
    second projection also its first's bias and its residual rows), plus
    the depth halves' partial tiles; the cluster's h, two groups of 32
    steps of the gates' input halves and two mbarriers (its recurrent
    weights stay in registers), or its hop's items, or its hop's K | V | Q
    rows and scores while they fit in ``SMEM_LIMIT`` beside the rest, else
    (``hop_streams``) the streamed hop's key tile, query rows, contexts
    and weights (``attend_rows_floats``)."""
    f, E = _dense(E_in), E_in
    for n in prenet:
        f, E = max(f, _dense(E)), n
    cb = min(_round8(E), BANK_C)
    f = max(f, (MT + K - 1) * _slab_ld(cb) + (K + 1) * cb * NI + 2 * NI)
    c1 = min(_round8(K * C), PROJ1_C)     # the pooled slab and its raw rows
    f = max(f, (2 * MT + 5) * _slab_ld(c1) + 3 * c1 * NI)
    c2 = min(_round8(P1), DENSE_C)
    f = max(f, (MT + 2) * _slab_ld(c2) + 3 * c2 * NI + c2 + NI + MT * NI,
            _dense(P2), _dense(W))
    r = max(_rnn_floats(H), _dense(2 * H), _dense(SA))
    if hop_streams(T, H, SA):
        r = max(r, attend_rows_floats(SA // heads))
    else:
        r = max(r, _hop_resident(T, SA))
    return 4 * (f + RED_FLOATS), 4 * (r + RED_FLOATS)


def _hop_resident(T: int, SA: int) -> int:
    return T * (_round8(3 * SA) + 4) + NWARPS * T


def dir_blocks(H: int) -> int:
    """The recurrent cluster's blocks a direction (``dir_blocks`` in
    csrc/fused_encoder.cu): 4 up to 128 units, 8 (a 16-block cluster) up
    to 256."""
    return 4 if H <= 4 * UNITS_A_BLOCK else 8


def _rnn_floats(H: int) -> int:
    """h by parity and two groups of 32 steps of a block's gate rows' input
    halves, and two mbarriers."""
    rows = 4 * -(-H // dir_blocks(H))
    return 2 * _round8(H) + 2 * RNN_GX_STEPS * rows + 4


def hop_streams(T: int, H: int, SA: int) -> bool:
    """Whether the recurrent cluster streams its hop's K | V | Q rows
    (``hop_streams`` in csrc/fused_encoder.cu): they and every warp's
    scores no longer fit in ``SMEM_LIMIT`` beside the rest of its plan
    (T > 533 at the recipes' widths, H = 128, SA = 32)."""
    r = max(_rnn_floats(H), _dense(2 * H), _dense(SA), _hop_resident(T, SA))
    return 4 * (r + RED_FLOATS) > SMEM_LIMIT


def attend_rows_floats(D: int) -> int:
    """The streamed hop's shared memory at head width D (mirrors
    csrc/attention_rows.cuh): a tile of 32 keys at an odd row stride, each
    warp's query row and context, each warp's tile of weights."""
    return 32 * (D | 1) + 2 * NWARPS * D + NWARPS * 32


class EncoderWidths(NamedTuple):
    """The widths and layer counts that decide whether the kernel takes an
    encoder (``encoder_widths`` reads them from merged weights)."""

    E_in: int                  # the embedded source
    prenet: Tuple[int, ...]    # each prenet layer's units
    K: int                     # the conv bank's widths 1..K
    C: int                     # its channels a width
    P1: int                    # the projections' channels
    P2: int
    W: int                     # the highway width (P2 or the adjustment's)
    H: int                     # the LSTM's units a direction
    SA: int                    # the self-attention width
    heads: int
    n_highway: int
    n_hops: int


def encoder_widths(params: FusedEncoderParams, E_in: int, K: int, C: int,
                   half: int, sa_units: int, num_heads: int) -> EncoderWidths:
    """The widths of merged weights (``SelfAttentionCBHGEncoder
    .fused_params``) and of the arguments ``fused_encode`` takes beside
    them."""
    P2 = int(params.w_proj2[0].shape[1])
    return EncoderWidths(
        E_in, tuple(int(w.shape[1]) for w, _ in params.prenet), K, C,
        int(params.w_proj1[0].shape[1]), P2,
        int(params.w_adjust[0].shape[1]) if params.w_adjust is not None
        else P2, half, sa_units, num_heads, len(params.highway),
        len(params.hops))


def unsupported_reason(w: EncoderWidths, T: int) -> Optional[str]:
    """Why the kernel cannot take this encoder at source length ``T``, or
    None, decided without a build (``prepare_encode`` raises with it): the
    two conditions the JAX kernel's shapes need as well (the residual adds
    the second projection to the prenet output; the heads split the
    self-attention width), an LSTM wider than the recurrent cluster holds
    (``MAX_HALF`` units a direction), and both blocks' shared-memory plans
    (``smem_bytes``) against the 227 KB a block may opt in to, the
    counterpart of the JAX kernel's VMEM bound.  Widths, layer counts and
    the source length are not limits: odd widths take the 4-byte copies
    (``vector_copies``), the layers come from a table in device memory,
    and past T = 533 at the recipes' widths the recurrent cluster streams
    its hop (``hop_streams``).  (A valid length outside [1, T] is a
    malformed input, which ``prepare_encode`` also raises for.)"""
    E = w.prenet[-1] if w.prenet else w.E_in
    if w.SA % w.heads:
        return f"sa_units {w.SA} do not divide over {w.heads} heads"
    if w.P2 != E:
        return f"residual needs proj2 width {w.P2} == prenet width {E}"
    if not 1 <= w.H <= MAX_HALF:
        return (f"the LSTM's {w.H} units a direction: the recurrent cluster "
                f"holds 1 to {MAX_HALF} ({UNITS_A_BLOCK} a block, 16 "
                "blocks)")
    if T < 1:
        return "an empty source"
    trunk, rnn = smem_bytes(T, w.E_in, w.prenet, w.K, w.C, w.P1, w.P2, w.W,
                            w.H, w.SA, w.heads)
    if max(trunk, rnn) > SMEM_LIMIT:
        return (f"the kernel's shared-memory plan needs {trunk} bytes a "
                f"trunk block and {rnn} a recurrent block (> {SMEM_LIMIT})")
    return None


def vector_copies(w: EncoderWidths) -> bool:
    """Whether every row the kernel copies is 16-byte aligned: each width
    it reads rows of (the source, the prenet layers, the bank, the
    projections, the highway, the LSTM's 2H outputs and 4H gates, the
    self-attention's SA and 3 SA) a multiple of 4.  Then it runs its
    instance with 16-byte copies (the recipes' widths), else the one with
    4-byte copies (the wrapper also takes it for an operand that is not
    16-byte aligned)."""
    widths = (w.E_in, *w.prenet, w.C, w.P1, w.P2, w.W, 2 * w.H, w.SA)
    return not any(n % 4 for n in widths)


def profile_split(cycles, ms: float):
    """{stage: (load, product, wait) in us}: block 0's cycles of a profiled
    launch (``launch.stage_cycles``), scaled so that they sum to the
    launch's measured time ``ms``."""
    n, total = len(ENC_PARTS), max(sum(cycles), 1)
    return {s: tuple(ms * 1e3 * c / total for c in cycles[i * n:(i + 1) * n])
            for i, s in enumerate(ENC_STAGES)}


def format_split(split) -> str:
    return "; ".join(
        f"{s} {sum(p):.2f} (" + ", ".join(
            f"{name} {v:.2f}" for name, v in zip(ENC_PARTS, p)) + ")"
        for s, p in split.items() if sum(p))


def _lib():
    lib = cuda_build.load("fused_encoder")
    if not getattr(lib, "_typed", False):
        lib.fused_encoder_scratch_floats.argtypes = [ctypes.POINTER(_EncArgs)]
        lib.fused_encoder_scratch_floats.restype = ctypes.c_longlong
        lib.fused_encoder_smem_bytes.argtypes = [ctypes.POINTER(_EncArgs),
                                                 ctypes.c_int]
        lib.fused_encoder_smem_bytes.restype = ctypes.c_longlong
        lib.fused_encoder_launch.argtypes = [ctypes.POINTER(_EncArgs), _P]
        lib.fused_encoder_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(t: Tensor, shape, name: str) -> Tensor:
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


# the layers' device tables, by (device, pointers, widths): a model's merged
# weights keep their pointers from call to call, so a table is copied to
# the card once
_tables: dict = {}
_MAX_TABLES = 16


def _layer_table(device, ptrs: Tuple[int, ...], widths: Tuple[int, ...]):
    """(pointer table (int64), width table (int32)) on ``device``."""
    key = (device, ptrs, widths)
    got = _tables.get(key)
    if got is None:
        if len(_tables) >= _MAX_TABLES:
            _tables.pop(next(iter(_tables)))
        got = (torch.tensor(ptrs or (0,), dtype=torch.int64).to(device),
               torch.tensor(widths or (0,), dtype=torch.int32).to(device))
        _tables[key] = got
    return got


def prepare_encode(params: FusedEncoderParams, x: Tensor, length, *,
                   max_filter_width: int, conv_channels: int, half: int,
                   sa_units: int, num_heads: int, zoneout_cell: float = 0.0,
                   zoneout_output: float = 0.0,
                   profile: bool = False) -> cuda_build.KernelLaunch:
    """Check and lay out the operands once; the returned launch runs the
    kernel and returns (lstm_out (T, 2H), sa_out (T, SA)).  With
    ``profile`` the launch also accumulates block 0's SM cycles into
    ``launch.stage_cycles`` (``ENC_STAGES`` x ``ENC_PARTS`` slots)."""
    L, K, C = int(length), max_filter_width, conv_channels
    zc, zo = zoneout_cell, zoneout_output
    T, E_in = int(x.shape[1]), int(x.shape[2])
    if not 1 <= L <= T:
        raise ValueError(f"length {L} outside [1, {T}]")
    widths = encoder_widths(params, E_in, K, C, half, sa_units, num_heads)
    reason = unsupported_reason(widths, T)
    if reason is not None:
        raise ValueError(f"fused_encode: {reason}")
    keep = []  # every tensor whose pointer the kernel reads

    def use(t, shape, name):
        t = _check(t, shape, name)
        keep.append(t)
        return t.data_ptr()

    a = _EncArgs()
    a.x = use(x[0], (T, E_in), "x")
    a.T, a.L, a.E_in = T, L, E_in
    a.n_prenet = len(params.prenet)
    a.pre_max = max((E_in, *widths.prenet))
    pre_w, pre_b, width = [], [], E_in
    for i, (w, b) in enumerate(params.prenet):
        n = int(w.shape[1])
        pre_w.append(use(w, (width, n), f"prenet{i}.w"))
        pre_b.append(use(b.reshape(-1), (n,), f"prenet{i}.b"))
        width = n
    E = width
    a.K, a.C = K, C
    a.bank_w = use(params.w_bank[0], (K * E, K * C), "w_bank")
    a.bank_b = use(params.w_bank[1].reshape(-1), (K * C,), "b_bank")
    P1, P2, W = widths.P1, widths.P2, widths.W
    a.P1, a.P2 = P1, P2
    a.p1_w = use(params.w_proj1[0], (3 * K * C, P1), "w_proj1")
    a.p1_b = use(params.w_proj1[1].reshape(-1), (P1,), "b_proj1")
    a.p2_w = use(params.w_proj2[0], (3 * P1, P2), "w_proj2")
    a.p2_b = use(params.w_proj2[1].reshape(-1), (P2,), "b_proj2")
    if params.w_adjust is not None:
        a.adj_w = use(params.w_adjust[0], (P2, W), "w_adjust")
        a.adj_b = use(params.w_adjust[1].reshape(-1), (W,), "b_adjust")
    a.W, a.H = W, half
    a.n_highway = len(params.highway)
    hw_w = [use(w, (W, 2 * W), f"highway{i}.w")
            for i, (w, _) in enumerate(params.highway)]
    hw_b = [use(b.reshape(-1), (2 * W,), f"highway{i}.b")
            for i, (_, b) in enumerate(params.highway)]
    wx, whT, b_lstm = params.lstm
    for d in range(2):
        a.lstm_wx[d] = use(wx[d], (W, 4 * half), f"lstm{d}.wx")
        a.lstm_whT[d] = use(whT[d], (4 * half, half), f"lstm{d}.whT")
        a.lstm_b[d] = use(b_lstm[d], (4 * half,), f"lstm{d}.b")
    a.zc, a.zo = float(zc), float(zo)
    SA = sa_units
    a.SA = SA
    a.sa_w = use(params.sa_proj[0], (2 * half, SA), "sa_proj.w")
    a.sa_b = use(params.sa_proj[1].reshape(-1), (SA,), "sa_proj.b")
    a.n_hops, a.n_heads = len(params.hops), num_heads
    kvq_w, kvq_b, ot_w, ot_b = [], [], [], []
    for i, (w_kvq, b_kvq, w_ot, b_ot) in enumerate(params.hops):
        kvq_w.append(use(w_kvq, (SA, 3 * SA), f"hop{i}.w_kvq"))
        kvq_b.append(use(b_kvq.reshape(-1), (3 * SA,), f"hop{i}.b_kvq"))
        ot_w.append(use(w_ot, (SA, SA), f"hop{i}.w_ot"))
        ot_b.append(use(b_ot.reshape(-1), (SA,), f"hop{i}.b_ot"))
    # the layers' table: a run of pointers for each field, in the order of
    # _EncArgs; the prenet's widths in a table of their own
    runs = [pre_w, pre_b, hw_w, hw_b, kvq_w, kvq_b, ot_w, ot_b]
    ptrs, widths_t = _layer_table(
        x.device, tuple(p for run in runs for p in run),
        tuple(int(w.shape[1]) for w, _ in params.prenet))
    keep += [ptrs, widths_t]
    slot, base = 0, ptrs.data_ptr()
    for field, run in zip(("pre_w", "pre_b", "hw_w", "hw_b", "kvq_w",
                           "kvq_b", "ot_w", "ot_b"), runs):
        setattr(a, field, base + 8 * slot)
        slot += len(run)
    a.pre_out = widths_t.data_ptr()
    a.v4 = int(vector_copies(widths)
               and all(t.data_ptr() % 16 == 0 for t in keep))

    lib = _lib()
    lstm_out = torch.empty(T, 2 * half, device=x.device)
    sa_out = torch.empty(T, SA, device=x.device)
    scratch = torch.empty(int(lib.fused_encoder_scratch_floats(
        ctypes.byref(a))), device=x.device)
    cycles = (torch.zeros(len(ENC_STAGES) * len(ENC_PARTS),
                          dtype=torch.int64, device=x.device)
              if profile else None)
    keep += [lstm_out, sa_out, scratch, cycles]
    a.lstm_out, a.sa_out, a.scratch = (lstm_out.data_ptr(),
                                       sa_out.data_ptr(), scratch.data_ptr())
    a.stage_cycles = cycles.data_ptr() if profile else None
    return cuda_build.KernelLaunch(lib.fused_encoder_launch, a, keep,
                                   (lstm_out, sa_out), x.device, fused_encode,
                                   stage_cycles=cycles)


def fused_encode(params: FusedEncoderParams, x: Tensor, length, *,
                 max_filter_width: int, conv_channels: int, half: int,
                 sa_units: int, num_heads: int, zoneout_cell: float = 0.0,
                 zoneout_output: float = 0.0) -> Tuple[Tensor, Tensor]:
    """The whole inference encoder at batch 1.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.shape[0] != 1:
        raise ValueError("the fused encoder is the batch-1 serving path")
    if not x.is_cuda:
        return fused_encode_reference(
            params, x, length, max_filter_width=max_filter_width,
            conv_channels=conv_channels, half=half, sa_units=sa_units,
            num_heads=num_heads, zoneout_cell=zoneout_cell,
            zoneout_output=zoneout_output)
    lstm_out, sa_out = prepare_encode(
        params, x, length, max_filter_width=max_filter_width,
        conv_channels=conv_channels, half=half, sa_units=sa_units,
        num_heads=num_heads, zoneout_cell=zoneout_cell,
        zoneout_output=zoneout_output)()
    return lstm_out[None], sa_out[None]


fused_encode.launches = 0
