"""The two attention kernels of the Pallas attention mode, in CUDA.

Counterpart of the JAX package's ``ops/pallas_attention.py`` (same module
and function names), whose Pallas TPU kernels become hand-written CUDA C++
kernels for sm_90a, built by ``ops/cuda_build.py`` and called through
``ctypes``:

* ``fused_self_attention`` — softmax(Q K^T / sqrt(D)) V over (B, H, T, D),
  optionally causal; replaces ``_attention_kernel``
  (``csrc/self_attention.cu``: a warp a 16 query rows, blocks of 16-64
  rows (128 in bf16) sized to the shape by ``attention_plan``, at small
  shapes 4 warps that share a block's rows and split its keys, K and V
  tiles in a ring of cp.async stages, both products on the tensor cores
  (the 3xTF32 split in f32, one bf16 mma a 16-deep step in bf16) and the
  online softmax in registers, D up to 128; past that its wide kernel,
  whose 8 warps split D's columns of 16 or 32 rows and add their partial
  scores through shared memory, on the same tensor-core products, and
  which splits each row block's keys over several blocks where the row
  blocks alone would leave most SMs idle);
* ``incremental_attention_step`` — one (B, H, D) query against (B, H, S, D)
  key and value caches masked to positions <= t; replaces
  ``_incremental_kernel`` (``csrc/incremental_attention.cu``: the cache up
  to t in chunks of 32 positions, one block each, merged by the chunk that
  finishes last in the same launch; in bf16 tiles of 64 positions over at
  most 8 blocks a head in one thread-block cluster, merged in the first
  block's shared memory (``step_plan_bf16``); past 256 wide, in either
  dtype, tiles of 16 positions folded a warp at a time over the blocks of
  ``step_plan_wide``, merged by tickets; positions > t never read, t a
  kernel argument).

``ops/attention_core.py`` selects them under ``use_pallas`` where no dropout
is active, as the JAX package does.  Heads wider than the full-sequence
kernel's narrow templates (D > ``MAX_MMA_HEAD_DIM``) take its wide
kernel, and heads wider than the step's registers hold (D > 256) the
step's wide kernel; ``attention_unsupported_reason`` /
``step_unsupported_reason`` name what is left (D > ``MAX_HEAD_DIM`` for
the full sequence, B * H past a grid).  Each has a plain PyTorch version
(``*_reference``: the einsum math of ``ops/attention_core.py`` with its
-1e9 fill).  The wrappers run it for CPU tensors only; a CUDA tensor
launches the kernel or raises, on a type, shape, layout or width the
kernel does not take and on an input that needs a gradient (neither
kernel has a backward; with the recipe's attention dropout neither runs in
training).  Each wrapper's ``launches`` counts its kernel launches (the
step's wide kernel, D > 256, in ``launches_wide``).

Both kernels take float32 or bfloat16 operands (every operand of a call in
one dtype; anything else raises, on the CPU too): bf16 q, k and v (the
model-wide bf16's hops, ``ops/compute_dtype.py``; its KV cache is bf16)
launch each kernel's bf16 instance, which reads bf16, sums in f32 (the
full sequence's on the bf16 tensor cores, P rounded once to bf16 for P V)
and writes bf16 once, as the JAX kernels do on bf16 inputs; those launches
count in ``launches_bf16``, the f32 ones in ``launches``.  The plain
versions compute in float32 on the upcast inputs and round the result to
q's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from . import cuda_build

NEG_INF = -1e9
MAX_MMA_HEAD_DIM = 128      # fused_self_attention's widest narrow template
MAX_HEAD_DIM = 1024         # its wide kernel's plan in 227 KB
# fused_self_attention's plan (mirrors csrc/self_attention.cu): query rows
# a block, from the most to the fewest; blocks that fill an H100's 132 SMs
# once; the warps that split the keys of a 16-row block that does not; the
# K / V ring's stages and the floats after each of its rows
ATTN_ROWS = (64, 32, 16)
ATTN_FILL_BLOCKS = 132
# bf16 operands: 8-warp blocks of these rows where they fill half the SMs
ATTN_BF16_ROWS = 128
ATTN_KEY_WARPS = 4
ATTN_RING = 3
ATTN_ROW_PAD = 4     # floats of padding after a ring row (8 bf16)
# the wide kernel (D > MAX_MMA_HEAD_DIM): the padded widths, its warps (a
# 16-row group each and a slice of the columns; 2 groups a block up to
# WIDE_TWO_GROUPS wide), the key tiles it tries, largest first, within a
# block's shared memory
WIDE_WIDTHS = (192, 256, 384, 512, 768, 1024)
WIDE_WARPS = 8
WIDE_TWO_GROUPS = 512
WIDE_KEYS = (32, 16, 8)
BLOCK_SMEM = 232448     # 227 KB, an H100 block's most
# what a profiled launch (prepare_attention(profile=True)) splits its SM
# cycles into
ATTN_STAGES = ("loads", "scores", "softmax", "values", "start", "end")
# incremental_attention_step: positions a block (STEP_CHUNK in the kernel)
STEP_CHUNK = 32
# its bf16 kernel (D <= STEP_MAX_D): positions a tile, blocks a head at most
# (one cluster)
STEP_MAX_D = 256
STEP_BF16_TILE = 64
STEP_BF16_CLUSTER = 8
# its wide kernel (D > STEP_MAX_D): positions a tile (8 warps x 2 rows),
# columns a slab (a block column of the grid), blocks of all heads and
# slabs at most (one an SM, on 96 of an H100's 132; chosen by timing 64 to
# 132 blocks at S = 3000, D = 512: ``scripts/torch_serving_ab.py --cases
# wide-plan``)
STEP_WIDE_TILE = 16
STEP_WIDE_SLAB = 512
STEP_WIDE_FILL = 96
# what prepare_step(passes=i + 1) keeps of the kernel (the last: all of it)
STEP_PASSES = ("scores", "softmax", "values", "all")

Tensor = torch.Tensor
_P = ctypes.c_void_p


def fused_self_attention_reference(q: Tensor, k: Tensor, v: Tensor,
                                   causal: bool = False) -> Tensor:
    """Plain PyTorch version: (B, H, T, D) -> (B, H, T, D), in float32,
    rounded to q's dtype."""
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return (torch.softmax(scores, dim=-1) @ v).to(dt)


def incremental_attention_step_reference(q_t: Tensor, key_cache: Tensor,
                                         value_cache: Tensor, t: int
                                         ) -> Tensor:
    """Plain PyTorch version: (B, H, D) against (B, H, S, D) caches, the
    positions past ``t`` filled with -1e9 -> (B, H, D), in float32,
    rounded to q_t's dtype."""
    dt = q_t.dtype
    q_t, key_cache, value_cache = (q_t.float(), key_cache.float(),
                                   value_cache.float())
    D, S = q_t.shape[-1], key_cache.shape[2]
    scores = torch.einsum("bhd,bhkd->bhk", q_t, key_cache) / math.sqrt(D)
    valid = (torch.arange(S, device=q_t.device) <= t)[None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return torch.einsum("bhk,bhkd->bhd", torch.softmax(scores, dim=-1),
                        value_cache).to(dt)


# ---------------------------------------------------------------- kernels

class _AttnArgs(ctypes.Structure):
    """Mirror of ``AttnArgs`` in csrc/self_attention.cu."""

    _fields_ = [("q", _P), ("k", _P), ("v", _P), ("o", _P),
                ("cycles", _P), ("bh", ctypes.c_int), ("T", ctypes.c_int),
                ("D", ctypes.c_int), ("causal", ctypes.c_int),
                ("scale", ctypes.c_float), ("rows", ctypes.c_int),
                ("key_warps", ctypes.c_int), ("elem", ctypes.c_int),
                ("splits", ctypes.c_int), ("chunk", ctypes.c_int),
                ("part", _P), ("tickets", _P)]


class _StepArgs(ctypes.Structure):
    """Mirror of ``StepArgs`` in csrc/incremental_attention.cu."""

    _fields_ = [("q", _P), ("k", _P), ("v", _P), ("o", _P), ("part", _P),
                ("tickets", _P), ("bh", ctypes.c_int), ("S", ctypes.c_int),
                ("D", ctypes.c_int), ("t", ctypes.c_int),
                ("chunk", ctypes.c_int), ("scale", ctypes.c_float),
                ("passes", ctypes.c_int), ("elem", ctypes.c_int),
                ("blocks", ctypes.c_int)]


class AttnPlan(NamedTuple):
    """One ``fused_self_attention`` launch: ``rows`` query rows a block,
    ``key_warps`` warps on each 16 of them (each takes a slice of every key
    tile; ``warps`` in all), ``grid`` = (row blocks, B * H), key tiles of
    ``keys`` keys through a ring of ``stages``, and ``smem_bytes`` of
    dynamic shared memory a block.  The wide kernel may split each row
    block's key tiles into ``splits`` blocks of ``chunk`` tiles, whose
    partial softmax states take ``part_floats`` floats of scratch."""

    rows: int
    key_warps: int
    warps: int
    grid: Tuple[int, int]
    keys: int
    stages: int
    smem_bytes: int
    splits: int = 1
    chunk: int = 0
    part_floats: int = 0


def attention_plan(B: int, H: int, T: int, D: int, causal: bool,
                   elem_bytes: int = 4) -> AttnPlan:
    """The kernel's plan at (B, H, T, D): the most rows a block
    (``ATTN_ROWS``, none past T's last 16) whose blocks still fill the card
    once, or else 16 rows on ``ATTN_KEY_WARPS`` warps that split the keys;
    for bf16 operands ``ATTN_BF16_ROWS`` (8 warps, one block an SM) where
    those blocks fill at least half the card;
    D padded to 16, 32, 64 or 128; tiles of 64 keys, 32 from 64 wide on
    (registers), 16 at 128 wide with a warp a row group (faster there); 64
    at every width for bf16 operands.  ``causal`` does not change the
    plan: a causal block stops at its last row's tile in the kernel.  The
    ring holds operands of ``elem_bytes`` (4: float32, 2: bf16) in rows
    padded by 16 bytes; with 4 key warps the block's merge reuses it and
    sizes it when it is the larger.  D > ``MAX_MMA_HEAD_DIM`` takes the
    wide kernel (``wide_plan``); where its row blocks would leave most SMs
    idle (fewer than ``ATTN_FILL_BLOCKS`` / 2), each row block's key tiles
    split into chunks of ``chunk``, one block each, whose partial softmax
    states (each warp's O fragments and the rows' max and sum, a thread's
    padded D / 8 or / 16, + 4 floats) the last to finish merges."""
    bh = B * H
    if D > MAX_MMA_HEAD_DIM:
        rows, keys, smem = wide_plan(D, elem_bytes)
        blocks, tiles = -(-T // rows), -(-T // keys)
        splits = min(tiles, max(1, ATTN_FILL_BLOCKS // (blocks * bh)))
        chunk = -(-tiles // splits)
        splits = -(-tiles // chunk)
        dp = next(w for w in WIDE_WIDTHS if D <= w)
        part = (bh * blocks * splits * WIDE_WARPS * 32
                * (dp * rows // 128 // 2 + 4) if splits > 1 else 0)
        return AttnPlan(rows, 1, WIDE_WARPS, (blocks, bh), keys, ATTN_RING,
                        smem, splits, chunk, part)
    rows = next((r for r in ATTN_ROWS if r < T + 16
                 and -(-T // r) * bh >= ATTN_FILL_BLOCKS), None)
    if elem_bytes == 2 and ATTN_BF16_ROWS < T + 16 and \
            -(-T // ATTN_BF16_ROWS) * bh >= ATTN_FILL_BLOCKS // 2:
        rows = ATTN_BF16_ROWS
    key_warps = 1 if rows else ATTN_KEY_WARPS
    rows = rows or ATTN_ROWS[-1]
    dp = next(w for w in (16, 32, 64, 128) if D <= w)
    keys = (64 if elem_bytes == 2 else 16 if (dp, key_warps) == (128, 1)
            else 32 if dp >= 64 else 64)
    ring = ATTN_RING * 2 * keys * (dp + ATTN_ROW_PAD * 4 // elem_bytes) \
        * elem_bytes
    merge = key_warps * (dp // 8 * 4 + 4) * 32 * 4 if key_warps > 1 else 0
    return AttnPlan(rows, key_warps, rows // 16 * key_warps,
                    (-(-T // rows), bh), keys, ATTN_RING, max(ring, merge))


def wide_plan(D: int, elem_bytes: int = 4) -> Tuple[int, int, int]:
    """(rows a block, keys a tile, shared-memory bytes) of the wide kernel
    at head width D: D padded to the next of ``WIDE_WIDTHS``; two 16-row
    groups a block up to ``WIDE_TWO_GROUPS`` wide, one past it (each warp
    holds O's and Q's fragments of D / 32 or D / 64 of the columns); the
    most keys of ``WIDE_KEYS`` whose ring (``ATTN_RING`` stages of K and V
    rows padded by 16 bytes) and partial score tiles (a 16 x keys float
    tile a warp) fit ``BLOCK_SMEM``."""
    dp = next(w for w in WIDE_WIDTHS if D <= w)
    rows = 32 if dp <= WIDE_TWO_GROUPS else 16

    def smem(keys):
        return (ATTN_RING * 2 * keys * (dp + ATTN_ROW_PAD * 4 // elem_bytes)
                * elem_bytes + WIDE_WARPS * 16 * keys * 4)
    keys = next(k for k in WIDE_KEYS if smem(k) <= BLOCK_SMEM)
    return rows, keys, smem(keys)


def kernel_plan(D: int, key_warps: int,
                elem_bytes: int = 4) -> Tuple[int, int, int]:
    """(keys a tile, stages, shared-memory bytes) of the built kernel at
    head width ``D``, ``key_warps`` and operands of ``elem_bytes``: the
    launcher's own numbers, which ``attention_plan`` mirrors.  Builds the
    kernel; raises for a width it does not take."""
    fn = cuda_build.load("self_attention").self_attention_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    if not fn(D, key_warps, elem_bytes, *map(ctypes.byref, out)):
        raise ValueError(f"fused_self_attention takes 1 <= D <= "
                         f"{MAX_HEAD_DIM} (key_warps 1 past "
                         f"{MAX_MMA_HEAD_DIM}), got {D}")
    return tuple(o.value for o in out)


def step_plan(bh: int, t: int, D: int) -> Tuple[int, int]:
    """(blocks a head, scratch floats) of one step at position ``t``: the
    cache up to ``t`` in chunks of ``STEP_CHUNK`` positions, one block each;
    with more than one chunk each writes its max, sum and unnormalised
    context row (D + 2 floats) for the last one to merge."""
    chunks = t // STEP_CHUNK + 1
    return chunks, (bh * chunks * (D + 2) if chunks > 1 else 0)


class WidePlan(NamedTuple):
    """One launch of the step's wide kernel: ``blocks`` of each (head,
    slab), tile j of a head to block j mod blocks; with more than one,
    each block leaves its partial to the scratch (``part_floats`` floats,
    0 for one block) and the last to take a ticket (one of ``tickets``
    words) merges them."""

    blocks: int
    slabs: int
    part_floats: int
    tickets: int


def step_plan_wide(bh: int, t: int, D: int) -> WidePlan:
    """The wide kernel's plan at position ``t`` (mirrors its launcher's
    checks in csrc/incremental_attention.cu): D in slabs of
    ``STEP_WIDE_SLAB`` columns; the cache up to t in tiles of
    ``STEP_WIDE_TILE``, over as many blocks a (head, slab) as fill
    ``STEP_WIDE_FILL`` with all heads and slabs, never more than the tiles
    (no block is empty)."""
    tiles = t // STEP_WIDE_TILE + 1
    slabs = -(-D // STEP_WIDE_SLAB)
    blocks = min(tiles, max(1, STEP_WIDE_FILL // (bh * slabs)))
    return WidePlan(blocks, slabs,
                    bh * slabs * blocks * (STEP_WIDE_SLAB + 2)
                    if blocks > 1 else 0, bh * slabs)


def step_plan_wide_tiles(plan: WidePlan, t: int) -> List[List[Tuple[int,
                                                                    int]]]:
    """The [first, end) positions of the tiles each block of a (head,
    slab) folds under ``plan``, in order."""
    tiles = t // STEP_WIDE_TILE + 1
    return [[(j * STEP_WIDE_TILE, min((j + 1) * STEP_WIDE_TILE, t + 1))
             for j in range(b, tiles, plan.blocks)]
            for b in range(plan.blocks)]


def step_plan_bf16(t: int) -> List[List[Tuple[int, int]]]:
    """The bf16 kernel's plan of one head at position ``t``: for each of
    its blocks (one cluster of at most ``STEP_BF16_CLUSTER``), the [first,
    end) positions of the tiles it folds, in order.  The cache up to ``t``
    in tiles of ``STEP_BF16_TILE``; tile j to block j mod nb, nb = min(8,
    tiles), so no block is empty; the blocks merge in the first one's
    shared memory, with no scratch."""
    tiles = t // STEP_BF16_TILE + 1
    nb = min(STEP_BF16_CLUSTER, tiles)
    return [[(j * STEP_BF16_TILE, min((j + 1) * STEP_BF16_TILE, t + 1))
             for j in range(r, tiles, nb)] for r in range(nb)]


def _fn(name: str, struct):
    lib = cuda_build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if not getattr(lib, "_typed", False):
        fn.argtypes = [ctypes.POINTER(struct), _P]
        fn.restype = ctypes.c_int
        lib._typed = True
    return fn


DTYPES = (torch.float32, torch.bfloat16)


def operand_dtype(*tensors: Tensor) -> torch.dtype:
    """The one dtype of a call's operands: float32 or bfloat16 (raises on
    any other, or on a mix)."""
    dt = tensors[0].dtype
    if dt not in DTYPES or any(t.dtype != dt for t in tensors):
        raise ValueError("the attention kernels take float32 or bfloat16 "
                         "operands, all of one dtype; got "
                         f"{[t.dtype for t in tensors]}")
    return dt


def _check(t: Tensor, shape, name: str, device) -> Tensor:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got one on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel reads contiguous tensors")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: the kernel has no backward")
    return t


MAX_GRID_Y = 65535    # B * H: the launches' second grid dimension


def attention_unsupported_reason(B: int, H: int, T: int,
                                 D: int) -> Optional[str]:
    """Why ``fused_self_attention`` cannot take (B, H, T, D), or None: the
    shapes ``prepare_attention`` raises for, decided without a build."""
    if not 1 <= D <= MAX_HEAD_DIM:
        return f"head width {D} outside [1, {MAX_HEAD_DIM}]"
    if T < 1:
        return "an empty sequence"
    if not 1 <= B * H <= MAX_GRID_Y:
        return f"B * H = {B * H} outside [1, {MAX_GRID_Y}]"
    return None


def step_unsupported_reason(B: int, H: int, S: int,
                            D: int) -> Optional[str]:
    """Why ``incremental_attention_step`` cannot take (B, H, S, D) caches,
    or None: the shapes ``prepare_step`` raises for at every position t <
    S, decided without a build (any head width: the wide kernel loops its
    columns)."""
    if D < 1:
        return f"head width {D} < 1"
    if S < 1:
        return "an empty cache"
    if not 1 <= B * H <= MAX_GRID_Y:
        return f"B * H = {B * H} outside [1, {MAX_GRID_Y}]"
    return None


def fused_self_attention(q: Tensor, k: Tensor, v: Tensor,
                         causal: bool = False) -> Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    operand_dtype(q, k, v)
    if not q.is_cuda:
        return fused_self_attention_reference(q, k, v, causal)
    return prepare_attention(q, k, v, causal)()


def prepare_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = False,
                      profile: bool = False) -> cuda_build.KernelLaunch:
    """Check the operands and lay out one launch by ``attention_plan``.
    With ``profile`` the launch adds the SM cycles of the last row block of
    head 0 (its warp 0; in the wide kernel the first row group's warp on
    the first columns) to ``stage_cycles``, one counter per
    ``ATTN_STAGES``."""
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, H, T, D), got {tuple(q.shape)}")
    B, H, T, D = q.shape
    bf16 = operand_dtype(q, k, v) == torch.bfloat16
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, (B, H, T, D), name, q.device)
    reason = attention_unsupported_reason(B, H, T, D)
    if reason is not None:
        raise ValueError(f"fused_self_attention takes 1 <= D <= "
                         f"{MAX_HEAD_DIM}, T >= 1 and B * H <= {MAX_GRID_Y}; "
                         f"got {tuple(q.shape)}: {reason}")
    out = torch.empty_like(q)
    plan = attention_plan(B, H, T, D, causal, q.element_size())
    cycles = (torch.zeros(len(ATTN_STAGES), dtype=torch.int64,
                          device=q.device) if profile else None)
    part = tickets = None
    if plan.splits > 1:
        part = torch.empty(plan.part_floats, device=q.device)
        tickets = cuda_build.ticket_words(
            q.device, plan.grid[0] * plan.grid[1], "self_attention")
    args = _AttnArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(),
                     cycles.data_ptr() if profile else None, B * H, T, D,
                     int(causal), 1.0 / math.sqrt(D), plan.rows,
                     plan.key_warps, int(bf16), plan.splits, plan.chunk,
                     part.data_ptr() if part is not None else None,
                     tickets.data_ptr() if tickets is not None else None)
    return cuda_build.KernelLaunch(
        _fn("self_attention", _AttnArgs), args,
        (q, k, v, out, cycles, part, tickets), out, q.device,
        fused_self_attention, stage_cycles=cycles,
        counter="launches_bf16" if bf16 else "launches")


def incremental_attention_step(q_t: Tensor, key_cache: Tensor,
                               value_cache: Tensor, t: int) -> Tensor:
    """(B, H, D) query against (B, H, S, D) caches at positions <= ``t`` (a
    Python int) -> (B, H, D).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    operand_dtype(q_t, key_cache, value_cache)
    if not q_t.is_cuda:
        return incremental_attention_step_reference(q_t, key_cache,
                                                    value_cache, t)
    return prepare_step(q_t, key_cache, value_cache, t)()


def launch_floor(device) -> Callable[[], None]:
    """A launch of an empty kernel on the current stream (not counted): the
    floor under one step's time in a queued loop."""
    fn = cuda_build.load("incremental_attention") \
        .incremental_attention_empty_launch
    fn.argtypes, fn.restype = [_P], ctypes.c_int

    def launch():
        err = fn(torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
    return launch


def prepare_step(q_t: Tensor, key_cache: Tensor, value_cache: Tensor, t: int,
                 passes: int = 0) -> cuda_build.KernelLaunch:
    """Check the operands and lay out one step's launch (its scratch from
    ``step_plan``, or from ``step_plan_wide`` past ``STEP_MAX_D``; the bf16
    kernel's plan, ``step_plan_bf16``, needs none).  ``passes`` cuts the f32 and wide kernels short for a
    profile: pass i + 1 keeps ``STEP_PASSES[:i + 1]`` (0: all of it)."""
    if key_cache.dim() != 4:
        raise ValueError(f"key_cache: expected (B, H, S, D), got "
                         f"{tuple(key_cache.shape)}")
    B, H, S, D = key_cache.shape
    bf16 = operand_dtype(q_t, key_cache, value_cache) == torch.bfloat16
    _check(q_t, (B, H, D), "q_t", q_t.device)
    _check(key_cache, (B, H, S, D), "key_cache", q_t.device)
    _check(value_cache, (B, H, S, D), "value_cache", q_t.device)
    t = int(t)
    if step_unsupported_reason(B, H, S, D) is not None or not 0 <= t < S:
        raise ValueError(f"incremental_attention_step takes D >= 1, 0 <= t "
                         f"< S and B * H <= {MAX_GRID_Y}; got D={D}, t={t}, "
                         f"S={S}, B * H={B * H}")
    wide = D > STEP_MAX_D
    bf16_narrow = bf16 and not wide
    if bf16_narrow and passes:
        raise ValueError("the bf16 kernel has no profile cuts (passes)")
    out = torch.empty_like(q_t)
    blocks = 0
    words = B * H
    if wide:
        plan = step_plan_wide(B * H, t, D)
        chunk, floats, words = STEP_WIDE_TILE, plan.part_floats, plan.tickets
        blocks = plan.blocks
    elif bf16_narrow:
        chunk, floats = STEP_BF16_TILE, 0
    else:
        chunk, floats = STEP_CHUNK, step_plan(B * H, t, D)[1]
    part = torch.empty(floats, device=q_t.device)
    tickets = cuda_build.ticket_words(q_t.device, words, "step")
    args = _StepArgs(q_t.data_ptr(), key_cache.data_ptr(),
                     value_cache.data_ptr(), out.data_ptr(),
                     part.data_ptr() if floats else None,
                     tickets.data_ptr(), B * H, S, D, t, chunk,
                     1.0 / math.sqrt(D), int(passes), int(bf16), blocks)
    return cuda_build.KernelLaunch(
        _fn("incremental_attention", _StepArgs), args,
        (q_t, key_cache, value_cache, out, part, tickets), out, q_t.device,
        incremental_attention_step,
        counter="launches_wide" if wide else
        "launches_bf16" if bf16 else "launches")


fused_self_attention.launches = fused_self_attention.launches_bf16 = 0
incremental_attention_step.launches = 0
incremental_attention_step.launches_bf16 = 0
incremental_attention_step.launches_wide = 0
