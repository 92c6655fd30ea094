"""Fused scatter + dense-Adam step on the feature tables.

Port of the TPU kernels of ``shine_mapping_tpu/ops/adam_kernel.py``:

* :func:`fused_adam`       — one level's ``(C, D)`` table; replaces ``_kernel``
  (K1, reached by ``fused_adam_packed``).
* :func:`fused_adam_multi` — all levels' ``(C_l, D)`` tables in one launch,
  each level with its own lr; replaces ``_kernel_multi`` (K2, reached by
  ``fused_adam_packed_multi`` and ``fused_adam_packed_multi_pre``, which run
  on the levels' tables concatenated; here the kernel takes one base pointer
  per level, so the tables stay where they are).
* :func:`fused_adam_levels` — K1's per-level step over L levels in ONE
  launch: each level its own table and lr, as L :func:`fused_adam` calls
  (the trainer's per-level branch; one prep and one launch a step).
* :func:`fused_adam_shard` — K2 over one row shard: each level's contiguous
  block of rows, every row swept, entries routed to it (K2's row-sharded
  caller ``fused_adam_packed_shard``, adam_kernel.py:528).

Both launch the one CUDA kernel of ``csrc/fused_adam.cu`` (K1 with one
level).  The table dtypes pick its variant (:data:`VARIANTS`): float32 p, m
and v; float32 p with bfloat16 moments (``tpu.moments_bf16``); or bfloat16
p, m and v (``tpu.params_bf16``, K2 only), whose new parameters are written
back with stochastic rounding seeded by a per-step ``sr_seed``.
``grads_bf16`` rounds every gradient entry to bfloat16 before the sum (the
JAX package's bf16 update mode).  The arithmetic is float32 in every
variant; bf16 moments are stored back rounded to nearest even.

Beside them, :func:`fused_adam_plain` and :func:`fused_adam_multi_plain`
compute the same step in plain torch (``index_add_`` into a dense gradient,
then the dense-Adam formula of ``_xla_update_lanes``, adam_kernel.py:808-818,
per level, and ``sr_round_bf16``, :778, for bf16 p).  A wrapper takes the
plain version only for tensors on the CPU (the tests); on a CUDA tensor it
launches the kernel or raises.  The card has no use for the TPU's packed
``(R, 128)`` layout or ``lanefold``: a ``(C, D)`` table is contiguous here,
so gradients arrive as narrow ``(M, D)`` rows.

Semantics (both versions): every row of each level's used head
``[0, n_used_l)`` takes one dense-Adam step — untouched rows decay — and rows
past it are not touched.  Trashbin entries (row ``C_l - 1``, missed lookups)
carry zero gradients by construction and are ignored.  ``n_used`` is the
caller's promise that no other entry lies past the head
(``used_rows_hint``); the wrappers return the number of entries that broke
it as a 0-dim device tensor (no host sync).  Such entries are left out of
the step.

The gradient-independent part of a step — the entries' rows globalised and
binned by the kernel's tile — is an :class:`EntryPrep` (:func:`entry_prep`):
on CUDA tensors the kernels of ``csrc/entry_prep.cu`` (after one memset, so
a live step is five device ops in all), on CPU tensors their plain version,
a stable sort.  A caller whose batches are known in advance (the trainer's
epoch windows) computes it once per batch and passes it as ``pre=``, so the
step is the update kernel alone.  The kernel reads each level's gradients in
place; tables and gradients must be contiguous and start on a 16-byte
boundary.

All functions update ``p``, ``m``, ``v`` in place.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build

# table dtypes (p, m = v) -> variant; the three the TPU kernels take
VARIANTS = {
    (torch.float32, torch.float32): "f32",
    (torch.float32, torch.bfloat16): "bf16m",
    (torch.bfloat16, torch.bfloat16): "bf16p",
}
_C_ENTRY = {"f32": "fused_adam_f32", "bf16m": "fused_adam_f32p_bf16m",
            "bf16p": "fused_adam_bf16p_bf16m"}
_SUFFIX = {"f32": "", "bf16m": "_bf16m", "bf16p": "_bf16p"}

# launches of the CUDA kernel, by entry point and variant; chip_smoke.py
# zeroes and reads them around the main path to show that it ran through
# the kernel
LAUNCHES: Dict[str, int] = {
    "fused_adam": 0, "fused_adam_bf16m": 0,  # K1: one level, or L by fused_adam_levels
    "fused_adam_multi": 0, "fused_adam_multi_bf16m": 0, "fused_adam_multi_bf16p": 0,
    "entry_prep": 0,  # csrc/entry_prep.cu, one per prep (its three kernels)
    # K2 over one row shard (fused_adam_shard)
    "fused_adam_multi_shard": 0, "fused_adam_multi_shard_bf16m": 0,
    "fused_adam_multi_shard_bf16p": 0,
}

# the levels those launches stepped, by the same keys: K1's per-level step
# counts one launch and L levels a step
LEVEL_STEPS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

MAX_LEVELS = 16  # csrc/fused_adam.cu MAX_LEVELS
_SENTINEL = 2 ** 31 - 1  # sorts past every row; no tile covers it
# entries one work item of the update kernel sums: a tile with more is
# split over ceil(n / ENTRY_CHUNK) CTAs (csrc/fused_adam.cu, the prep's
# work list)
ENTRY_CHUNK = 512


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LEVEL_STEPS[k] = 0


def used_rows_hint(n_corners, sizes, granularity: int = 16) -> Tuple[int, ...]:
    """Per-level used-row counts, rounded UP to ``capacity / granularity``.

    Rows >= the allocated corner count never appear in lookups (corner ids
    are allocated densely from 0) and keep zero moments and gradients, so
    dense Adam leaves them unchanged and the kernel skips them (the capacity
    headroom after doubling, 25-50% of a table).  The JAX package's
    ``used_rows_hint`` with ``sizes`` the per-level row counts C_l."""
    out = []
    for n, C in zip(n_corners, sizes):
        step = max(int(C) // granularity, 1)
        out.append(int(min(C, ((int(n) + step - 1) // step) * step)))
    return tuple(out)


# ------------------------------------------------------------------ checks


def _check_tables(ps, ms, vs) -> str:
    """Per-level tables: contiguous (C_l, D), p/m/v of one shape, m and v of
    one dtype, one D, one device and one variant for all levels.  Returns
    the variant (:data:`VARIANTS`)."""
    L = len(ps)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {L}")
    if len(ms) != L or len(vs) != L:
        raise ValueError("one p, m and v table per level")
    variants = set()
    dev, D = ps[0].device, ps[0].shape[-1]
    for p, m, v in zip(ps, ms, vs):
        key = (p.dtype, m.dtype)
        if m.dtype != v.dtype or key not in VARIANTS:
            raise TypeError(
                f"fused Adam takes p/m/v as float32/float32/float32, "
                f"float32/bfloat16/bfloat16 or bfloat16/bfloat16/bfloat16, got "
                f"{p.dtype}/{m.dtype}/{v.dtype}")
        variants.add(VARIANTS[key])
        shape = p.shape
        if not (len(shape) == 2 and p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous() and m.shape == shape and v.shape == shape):
            raise ValueError("p, m and v must be contiguous (rows, D) tensors of one shape")
        if not (p.device == dev and m.device == dev and v.device == dev):
            raise ValueError("p, m and v must share shape and device")
        if shape[1] != D:
            raise ValueError("all levels must share D and device")
    if len(variants) != 1:
        raise TypeError(f"all levels must share the table dtypes, got {sorted(variants)}")
    return variants.pop()


def _levels(ps, n_used, lr, lr_scales):
    """Per-level row counts, used heads, global row offsets and lrs."""
    sizes = [int(p.shape[0]) for p in ps]
    L = len(sizes)
    n_used = list(sizes) if n_used is None else [int(n) for n in n_used]
    if len(n_used) != L or any(not 0 <= n <= C for n, C in zip(n_used, sizes)):
        raise ValueError(f"n_used {n_used} must lie in [0, C_l] for sizes {sizes}")
    offs = [0] * L
    for l in range(1, L):
        offs[l] = offs[l - 1] + sizes[l - 1]
    lrs = [float(lr) * float(s) for s in lr_scales]
    if len(lrs) != L:
        raise ValueError("one lr scale per level")
    return sizes, n_used, offs, lrs


def _per_level(ps, rows_list, g_list):
    if len(rows_list) != len(ps) or len(g_list) != len(ps):
        raise ValueError("one rows tensor and one grads tensor per level")


# ------------------------------------------------------------------ entry prep


def tile_rows(D: int) -> int:
    """Rows per tile of the kernel (csrc/fused_adam.cu) for feature width
    ``D``: a multiple of 8, so every tile starts on an aligned group of 8
    elements, and at most 2,048 elements (8 KB of f32 sums) where D allows
    (256 rows at D 8)."""
    return max(8, (2048 // int(D)) // 8 * 8)


def _tiles(n_used: Sequence[int], tb: int) -> Tuple[List[int], int]:
    """First tile of each level and the total, for used heads ``n_used``."""
    lo, T = [], 0
    for nu in n_used:
        lo.append(T)
        T += -(-int(nu) // tb)
    return lo, T


class EntryPrep(NamedTuple):
    """What a step needs of its entries' rows alone (no gradients): the
    entries binned by the kernel's tile.

    rows:     (M,) int32 — the entries' GLOBAL rows (level l's row r is
              ``sum(sizes[:l]) + r``), grouped by tile: tile t's entries
              are positions ``[tile_off[t], tile_off[t + 1])``; trashbin
              entries and entries past a used head follow ``tile_off[T]``
              with a sentinel row past every row
    order:    (M,) int32 — position j holds entry ``order[j]`` of the
              levels' entries concatenated
    tile_off: (T + 1,) int32 — tile t covers rows ``[k tb, (k + 1) tb)`` of
              the used head of its level (tiles numbered level by level)
    dropped:  () int64 — entries past a used head (trashbin rows excluded)
    sizes, n_used, tb: the per-level table rows, used heads and rows per
              tile it was built for
    sorted_by_row: the entries are sorted by (row, entry), so each row's
              entries lie next to each other (what the kernel's
              deterministic sum reads)
    the update kernel's work list (``chunk`` 0 and None: every tile is one
    work item, as for :func:`entry_prep_local`'s):
    split_off:   (T,) int32 — each tile's first extra work item: a tile of
              n > chunk entries is summed by k = ceil(n / chunk) CTAs, its
              own and k - 1 extra ones
    split_items: (E_max, 2) int32 — each extra item's (tile, chunk j >= 1);
              E_max = M // chunk + 1 bounds their number
    n_split:  () int32 — the number of extra items
    chunk:    entries a work item sums

    The plain version (CPU tensors) sorts the entries by row, stably: one
    valid grouping, sorted.  The kernel's (CUDA tensors) leaves the order
    inside a tile to its atomics: not sorted.  Both write the same work list
    (the first ``n_split`` items; the kernel leaves the rest unwritten).
    """

    rows: torch.Tensor
    order: torch.Tensor
    tile_off: torch.Tensor
    dropped: torch.Tensor
    sizes: Tuple[int, ...]
    n_used: Tuple[int, ...]
    tb: int
    sorted_by_row: bool = False
    split_off: Optional[torch.Tensor] = None
    split_items: Optional[torch.Tensor] = None
    n_split: Optional[torch.Tensor] = None
    chunk: int = 0


def entry_prep(rows_list: Sequence[torch.Tensor], sizes: Sequence[int],
               n_used: Optional[Sequence[int]], dim: int) -> EntryPrep:
    """The :class:`EntryPrep` of per-level corner rows ``rows_list[l]`` (any
    shape, int32/int64) for tables of ``sizes[l]`` rows of width ``dim``
    with used heads ``n_used`` (None = whole tables).  The port's
    counterpart of ``entry_prep_lanes`` / ``entry_prep_multi``
    (adam_kernel.py:940, :307)."""
    return entry_prep_stack(rows_list, sizes, n_used, dim, stack=False)


def entry_prep_stack(rows_list: Sequence[torch.Tensor], sizes: Sequence[int],
                     n_used: Optional[Sequence[int]], dim: int,
                     stack: bool = True) -> EntryPrep:
    """:func:`entry_prep` of W batches at once: ``rows_list[l]`` is level
    l's rows of every batch, ``(W, ...)``.  Returns an EntryPrep whose rows
    and order are ``(W, M)``, tile_off ``(W, T + 1)`` and dropped ``(W,)``;
    :func:`window_prep` takes batch w's.  On CUDA tensors one launch of
    csrc/entry_prep.cu (a memset and three kernels), for all W (the
    trainer's epoch windows); on CPU tensors :func:`entry_prep_stack_plain`.
    ``stack=False``: the rows are one batch of any shape and the prep is
    that batch's (:func:`entry_prep`)."""
    sizes = tuple(int(c) for c in sizes)
    n_used = sizes if n_used is None else tuple(int(n) for n in n_used)
    if len(rows_list) != len(sizes) or len(n_used) != len(sizes):
        raise ValueError("one rows tensor, size and used head per level")
    if not 1 <= len(sizes) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {len(sizes)}")
    if any(not 0 <= n <= C for n, C in zip(n_used, sizes)):
        raise ValueError(f"n_used {n_used} must lie in [0, C_l] for sizes {sizes}")
    if sum(sizes) >= _SENTINEL:
        raise ValueError("tables of 2**31 - 1 rows or more in all are not supported")
    device = rows_list[0].device
    W = rows_list[0].shape[0] if stack else None
    for rows in rows_list:
        if rows.dtype not in (torch.int32, torch.int64):
            raise TypeError("rows must be int32/int64")
        if rows.device != device or (stack and rows.shape[0] != W):
            raise ValueError("all levels' rows must lie on one device, W batches each")
    tb = tile_rows(dim)
    if not stack and device.type == "cpu":
        return window_prep(entry_prep_stack_plain([r.reshape(1, -1) for r in rows_list],
                                                  sizes, n_used, tb), 0)
    if device.type == "cpu":
        return entry_prep_stack_plain(rows_list, sizes, n_used, tb)
    if device.type != "cuda":
        raise ValueError(f"entry_prep runs on cuda (or cpu), not {device}")
    return _prep_launch(rows_list, sizes, n_used, tb, stack=stack)


def entry_prep_stack_plain(rows_list, sizes, n_used, tb: int,
                           chunk: int = ENTRY_CHUNK) -> EntryPrep:
    """The plain torch version of :func:`entry_prep_stack` (any device): the
    rows globalised (sentinel for trashbin and out-of-head entries), a
    stable sort, each tile's first position by ``searchsorted``, and the
    work list (:func:`work_list_plain`; ``chunk`` 0: none)."""
    device = rows_list[0].device
    W = rows_list[0].shape[0]
    rows_g = []
    dropped = torch.zeros(W, dtype=torch.int64, device=device)
    bounds = []
    off = 0
    for rows, C, nu in zip(rows_list, sizes, n_used):
        r = rows.reshape(W, -1).to(torch.int64)
        trash = r == C - 1
        inside = (r >= 0) & (r < nu) & ~trash
        dropped = dropped + (~inside & ~trash).sum(dim=1)
        rows_g.append(torch.where(inside, r + off, _SENTINEL).to(torch.int32))
        bounds.append(torch.arange(0, nu, tb, dtype=torch.int64, device=device) + off)
        off += C
    rows_s, order = torch.sort(torch.cat(rows_g, dim=1), dim=1, stable=True)
    bounds.append(torch.tensor([_SENTINEL], dtype=torch.int64, device=device))
    b = torch.cat(bounds).to(torch.int32).expand(W, -1).contiguous()
    tile_off = torch.searchsorted(rows_s, b).to(torch.int32)
    split = work_list_plain(tile_off, rows_s.shape[1], chunk) if chunk else (None,) * 3
    return EntryPrep(rows_s.contiguous(), order.to(torch.int32), tile_off, dropped,
                     tuple(int(c) for c in sizes), tuple(int(n) for n in n_used), tb, True,
                     *split, chunk)


def work_list_plain(tile_off: torch.Tensor, M: int, chunk: int):
    """The update kernel's work list from W batches' tile offsets ``(W, T
    + 1)`` (M entries a batch): the plain version of what csrc/entry_prep.cu's
    scan writes.  A tile of n > ``chunk`` entries takes k - 1 = (n - 1) //
    chunk extra items.  Returns (split_off (W, T), split_items (W, E_max, 2)
    with E_max = M // chunk + 1, zero past each batch's count, n_split (W,)),
    all int32."""
    W, T = tile_off.shape[0], tile_off.shape[1] - 1
    dev = tile_off.device
    n = (tile_off[:, 1:] - tile_off[:, :-1]).to(torch.int64)[:, :T]
    ex = torch.where(n > chunk, torch.div(n - 1, chunk, rounding_mode="floor"), 0)
    off = torch.cumsum(ex, dim=1) - ex
    E_max = int(M) // chunk + 1
    items = torch.zeros((W * E_max, 2), dtype=torch.int32, device=dev)
    flat = ex.reshape(-1)
    which = torch.repeat_interleave(torch.arange(W * T, device=dev), flat)
    if which.numel():
        first = torch.repeat_interleave(torch.cumsum(flat, 0) - flat, flat)
        j = torch.arange(which.numel(), device=dev) - first + 1
        pos = torch.div(which, T, rounding_mode="floor") * E_max + off.reshape(-1)[which] + j - 1
        items[pos] = torch.stack((which % T, j), dim=1).to(torch.int32)
    return (off.to(torch.int32), items.reshape(W, E_max, 2), ex.sum(dim=1).to(torch.int32))


_PREP_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
                  + [ctypes.POINTER(ctypes.c_longlong)] * 3
                  + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
_prep_fn = None  # csrc/entry_prep.cu's entry_prep, resolved at the first launch


def _stream(device: torch.device):
    """The current raw CUDA stream of ``device`` and whether it is the
    current device (else the caller enters it)."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev), dev == torch.cuda.current_device()


def _prep_launch(rows_list, sizes, n_used, tb, trash=None, chunk=ENTRY_CHUNK,
                 stack=True) -> EntryPrep:
    """csrc/entry_prep.cu on CUDA rows (counted under ``entry_prep``), with
    the update's work list for ``chunk`` (0: none).  ``stack``: the rows
    are ``(W, ...)`` batches and the outputs stack them; else the rows are
    one batch (any shape) and the prep is that batch's, as
    :func:`window_prep` would cut it.  ``trash``: per level the row count
    whose last row is the excluded trashbin (default ``sizes``; 0 makes the
    pad row -1 the excluded one).  Every output lies in one int32
    allocation, the scratch in another."""
    global _prep_fn
    if _prep_fn is None:
        fn = cuda_build.load("entry_prep").entry_prep
        fn.argtypes, fn.restype = _PREP_ARGTYPES, ctypes.c_int
        _prep_fn = fn
    device = rows_list[0].device
    W = rows_list[0].shape[0] if stack else 1
    L = len(sizes)
    rows = [r.reshape(W, -1) for r in rows_list] if stack else rows_list
    ent_off = [0]
    for r in rows:
        if not r.is_contiguous():
            raise ValueError("rows must be contiguous")
        ent_off.append(ent_off[-1] + r.numel() // W)
    M = ent_off[-1]
    if M >= _SENTINEL or W > 65535:
        raise ValueError("at most 2**31 - 2 entries per batch and 65,535 batches")
    tile_lo, T = _tiles(n_used, tb)
    row_off = [0] * L
    for l in range(1, L):
        row_off[l] = row_off[l - 1] + sizes[l - 1]
    E_max = M // chunk + 1 if chunk else 0
    # the outputs in one allocation: dropped (int64) and split_items (int2 in
    # the kernels) first, on 8-byte boundaries; the scratch in another, so
    # that a stack of windows does not keep it
    n = [2 * W, 2 * W * E_max, W, W * (T + 1), W * M, W * M, W * T if chunk else 0]
    buf = torch.empty(sum(n), dtype=torch.int32, device=device)
    dropped, items, n_split, tile_off, rows_out, order, split_off = buf.split_with_sizes(n)
    counts, rank = torch.empty(W * (T + 2 + M), dtype=torch.int32,
                               device=device).split_with_sizes([W * (T + 2), W * M])
    rows64 = sum(1 << l for l, r in enumerate(rows) if r.dtype == torch.int64)
    dev, stream, current = _stream(device)
    args = ((ctypes.c_void_p * L)(*[r.data_ptr() for r in rows]), rows64,
            (ctypes.c_longlong * (L + 1))(*ent_off), L,
            (ctypes.c_longlong * L)(*(sizes if trash is None else trash)),
            (ctypes.c_longlong * L)(*n_used),
            (ctypes.c_longlong * L)(*row_off), (ctypes.c_int * L)(*tile_lo), tb, T, W,
            counts.data_ptr(), rank.data_ptr(), tile_off.data_ptr(),
            rows_out.data_ptr(), order.data_ptr(), dropped.data_ptr(), stream, chunk, E_max,
            split_off.data_ptr(), items.data_ptr(), n_split.data_ptr())
    if current:
        err = _prep_fn(*args)
    else:
        with torch.cuda.device(dev):
            err = _prep_fn(*args)
    if err != 0:
        raise RuntimeError(f"entry_prep kernel launch failed: CUDA error {err}")
    LAUNCHES["entry_prep"] += 1
    dropped = dropped.view(torch.int64)
    if stack:
        split = ((split_off.view(W, T), items.view(W, E_max, 2), n_split) if chunk
                 else (None,) * 3)
        return EntryPrep(rows_out.view(W, M), order.view(W, M), tile_off.view(W, T + 1),
                         dropped, tuple(sizes), tuple(n_used), tb, False, *split, chunk)
    split = (split_off, items.view(E_max, 2), n_split.view(())) if chunk else (None,) * 3
    return EntryPrep(rows_out, order, tile_off, dropped.view(()), tuple(sizes), tuple(n_used),
                     tb, False, *split, chunk)


def window_prep(pre: EntryPrep, w: int) -> EntryPrep:
    """Batch ``w``'s EntryPrep of a stack (:func:`entry_prep_stack`)."""
    split = ((None,) * 3 if pre.split_off is None
             else (pre.split_off[w], pre.split_items[w], pre.n_split[w]))
    return EntryPrep(pre.rows[w], pre.order[w], pre.tile_off[w], pre.dropped[w], pre.sizes,
                     pre.n_used, pre.tb, pre.sorted_by_row, *split, pre.chunk)


def _prep_for(pre, rows_list, sizes, n_used, D, device):
    """``pre``, checked against this call, or a fresh one (on CUDA rows
    csrc/entry_prep.cu straight away: the step has checked the sizes and
    heads)."""
    if pre is None:
        if any(r.device != device for r in rows_list):
            raise ValueError("entries must lie on the tables' device")
        if device.type != "cuda":
            return entry_prep(rows_list, sizes, n_used, D)
        if any(r.dtype not in (torch.int32, torch.int64) for r in rows_list):
            raise TypeError("rows must be int32/int64")
        if sum(sizes) >= _SENTINEL:
            raise ValueError("tables of 2**31 - 1 rows or more in all are not supported")
        return _prep_launch(rows_list, sizes, n_used, tile_rows(D), stack=False)
    M = sum(int(r.numel()) for r in rows_list)
    if (pre.sizes != tuple(sizes) or pre.n_used != tuple(n_used) or pre.tb != tile_rows(D)
            or pre.rows.shape != (M,) or pre.rows.device != device):
        raise ValueError(
            f"pre was built for sizes {pre.sizes}, used heads {pre.n_used}, tiles of "
            f"{pre.tb} rows and {tuple(pre.rows.shape)} entries on {pre.rows.device}; this "
            f"step has {tuple(sizes)}, {tuple(n_used)}, {tile_rows(D)}, {M} on {device}")
    return pre


def _sorted_grads(pre: EntryPrep, g_list, D: int) -> torch.Tensor:
    """The levels' (…, D) float32 gradients concatenated, in ``pre``'s
    order: (M, D), contiguous (the plain version's gather)."""
    gs = [g.reshape(-1, D) for g in g_list]
    for g in gs:
        if g.dtype != torch.float32:
            raise TypeError("grads must be float32")
        if g.device != pre.rows.device:
            raise ValueError("entries must lie on the tables' device")
    g = gs[0] if len(gs) == 1 else torch.cat(gs)
    if g.shape[0] != pre.rows.shape[0]:
        raise ValueError(f"{pre.rows.shape[0]} rows but {g.shape[0]} gradient rows")
    return g.index_select(0, pre.order)


# ------------------------------------------------------------------ plain versions

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Philox4x32 multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl key increments
_SR_KEY = 0x53524E44  # the second key word of the rounding noise


def _mulhilo(a: torch.Tensor, b: int):
    """High and low 32-bit words of ``a * b`` for int64 ``a`` holding
    uint32 values and a uint32 constant ``b``, without leaving int64."""
    p1 = a * (b & 0xFFFF)  # < 2**48
    p2 = a * (b >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (s >> 32), s & _U32


def philox_noise16(seed: int, level: int, n: int, device="cpu", start: int = 0) -> torch.Tensor:
    """The kernel's 16-bit stochastic-rounding noise for elements ``[start,
    start + n)`` of level ``level`` (row-major), as int32: Philox4x32-10
    with counter (group lo, group hi, level, 0) and key (seed, 0x53524E44),
    one call per group of 8 elements, element 8 k + j taking bits 16 (j & 1)
    of word j >> 1 (csrc/fused_adam.cu).  ``start`` (a multiple of 8) is a
    row shard's first element in its whole table."""
    if int(start) % 8:
        raise ValueError(f"start {start} must be a multiple of 8")
    k = torch.arange(-(-int(n) // 8), dtype=torch.int64, device=device) + int(start) // 8
    c0, c1 = k & _U32, k >> 32
    c2 = torch.full_like(k, int(level) & _U32)
    c3 = torch.zeros_like(k)
    k0, k1 = int(seed) & _U32, _SR_KEY
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    words = torch.stack((c0, c1, c2, c3), dim=1)  # (groups, 4)
    halves = torch.stack((words & 0xFFFF, words >> 16), dim=2)  # (groups, 4, 2)
    return halves.reshape(-1)[: int(n)].to(torch.int32)


def sr_round_bf16_plain(x: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """Stochastically round float32 ``x`` to bfloat16: add the 16 noise bits
    ``noise16`` (any integer dtype, same shape; only the low 16 bits are
    read) below the bf16 mantissa cut, then truncate.  Carries run into the
    exponent; non-finite values pass through.  Bit-exact to the JAX
    package's ``sr_round_bf16`` (adam_kernel.py:778) given the same bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits + (noise16.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    return torch.where(torch.isfinite(x), out.view(torch.float32), x).to(torch.bfloat16)


@torch.no_grad()
def fused_adam_multi_plain(ps, ms, vs, rows_list, g_list, lr, bc1, bc2,
                           lr_scales, n_used=None, b1: float = 0.9,
                           b2: float = 0.99, eps: float = 1e-15,
                           grads_bf16: bool = False, sr_seed: Optional[int] = None,
                           pre: Optional[EntryPrep] = None, noise16=None):
    """The plain torch version of :func:`fused_adam_multi` (any device).

    Rounds each operation once, as the kernel does: the bias corrections
    divide as 0-dim tensors (a Python scalar divisor becomes a multiply by
    its reciprocal on CUDA tensors) and the square root is taken in
    float64.  With bf16 p the stochastic rounding takes the kernel's bits,
    :func:`philox_noise16` keyed by ``sr_seed``, or ``noise16[l]`` (level
    l's 16-bit noise, ``C_l * D`` elements in row-major order) from the
    caller: a seam that lets a test feed the JAX package's bits."""
    variant = _check_tables(ps, ms, vs)
    _per_level(ps, rows_list, g_list)
    sizes, n_used, offs, lrs = _levels(ps, n_used, lr, lr_scales)
    if variant == "bf16p" and sr_seed is None:
        raise ValueError("bf16 tables need a per-step sr_seed")
    device, D = ps[0].device, ps[0].shape[1]
    pre = _prep_for(pre, rows_list, sizes, n_used, D, device)
    gs = _sorted_grads(pre, g_list, D)
    _adam_levels_plain(variant, ps, ms, vs, pre.rows, gs, n_used, offs, lrs, bc1, bc2, b1, b2,
                       eps, grads_bf16, sr_seed, noise16, [0] * len(ps))
    return pre.dropped


def _adam_levels_plain(variant, ps, ms, vs, rows_s, gs, n_used, offs, lrs, bc1, bc2, b1, b2,
                       eps, grads_bf16, sr_seed, noise16, row_base):
    """The plain step over each level's head ``[0, n_used_l)``, from the
    binned rows ``rows_s`` (global: level l's start at ``offs[l]``) and their
    gradients ``gs`` in the same order.  ``row_base[l]``: the table's first
    row in its level's whole table (a row shard's), which keys the
    stochastic rounding."""
    device, D = ps[0].device, ps[0].shape[1]
    if grads_bf16:
        gs = gs.to(torch.bfloat16).to(torch.float32)
    bc1_t, bc2_t = (torch.tensor(float(b), dtype=torch.float32, device=device)
                    for b in (bc1, bc2))
    for l, (p, m, v, nu, off, lr_l) in enumerate(zip(ps, ms, vs, n_used, offs, lrs)):
        if nu == 0:
            continue
        sel = (rows_s >= off) & (rows_s < off + nu)
        gl = torch.zeros((nu, D), dtype=torch.float32, device=device).index_add_(
            0, (rows_s[sel] - off).to(torch.int64), gs[sel])
        m_new = b1 * m[:nu].float() + (1.0 - b1) * gl
        v_new = b2 * v[:nu].float() + (1.0 - b2) * gl * gl
        # the root in float64, rounded once: the correctly rounded float32 root
        # (torch's float32 sqrt on the CPU may miss it by an ulp)
        root = torch.sqrt((v_new / bc2_t).double()).float()
        p_new = p[:nu].float() - lr_l * (m_new / bc1_t) / (root + eps)
        if variant == "bf16p":
            if noise16 is not None:
                noise = noise16[l].reshape(-1)[: nu * D]
            else:
                noise = philox_noise16(sr_seed, l, nu * D, device, start=row_base[l] * D)
            p[:nu] = sr_round_bf16_plain(p_new, noise.reshape(nu, D))
        else:
            p[:nu] = p_new
        m[:nu] = m_new  # to bf16 moments: round to nearest even
        v[:nu] = v_new


def fused_adam_plain(p, m, v, rows, grads, lr, bc1, bc2, n_used=None,
                     b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                     grads_bf16: bool = False, pre: Optional[EntryPrep] = None):
    """The plain torch version of :func:`fused_adam` (any device): the
    multi-level plain version with one level."""
    return fused_adam_multi_plain(
        [p], [m], [v], [rows], [grads], lr, bc1, bc2, [1.0],
        None if n_used is None else [n_used], b1, b2, eps, grads_bf16, pre=pre)


# ------------------------------------------------------------------ kernel


def _entry_offsets(g_list, rows_list, D, device):
    """The kernel reads each level's gradients in place: float32, on the
    tables' device, contiguous, one (D,) row per entry.  Returns each
    level's first entry in the concatenation."""
    ent_off = [0]
    for g, r in zip(g_list, rows_list):
        if g.dtype != torch.float32:
            raise TypeError("grads must be float32")
        if g.device != device or r.device != device:
            raise ValueError("entries must lie on the tables' device")
        if not g.is_contiguous() or g.numel() != r.numel() * D:
            raise ValueError(f"grads must be contiguous with D = {D} values per entry row")
        ent_off.append(ent_off[-1] + r.numel())
    return ent_off[:-1]


def _check_aligned(named):
    """Each tensor's data_ptr, checked to lie on a 16-byte boundary; returns
    them, one list per name."""
    out = []
    for name, ts in named:
        ptrs = [t.data_ptr() for t in ts]
        for x in ptrs:
            if x % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                                 "reads it 16 bytes at a time); got a view at "
                                 f"{x % 16} bytes past one")
        out.append(ptrs)
    return out


_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] * 4
             + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 3
             + [ctypes.POINTER(ctypes.c_longlong)] * 2
             + [ctypes.POINTER(ctypes.c_float)]
             + [ctypes.c_float] * 7
             + [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
_EX_ARGTYPES = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]  # row_base, det
_SPLIT_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5  # chunk, E_max, work list, scratch
_entries: Dict[str, ctypes._CFuncPtr] = {}  # csrc/fused_adam.cu's, resolved at first use
# per device: the split tiles' f32 slots and arrival counters, zero between
# launches (each launch leaves them zero); grown when a launch needs more
_scratch: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def c_entry(lib: ctypes.CDLL, name: str) -> ctypes._CFuncPtr:
    """``lib.<name>`` (an entry point of csrc/fused_adam.cu, or of another
    copy of it with the same interface) with its C signature declared."""
    fn = getattr(lib, name)
    fn.argtypes = (_ARGTYPES + (_EX_ARGTYPES if "_ex_" in name else [])
                   + _SPLIT_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _split_scratch(dev: int, slots: int, elems: int):
    """Device ``dev``'s zeroed scratch for ``slots`` split tiles of
    ``elems`` elements: (f32 slots, int32 arrival counters)."""
    acc, arrive = _scratch.get(dev, (None, None))
    if acc is None or acc.numel() < slots * elems or arrive.numel() < slots:
        n = max(slots * elems, 0 if acc is None else acc.numel())
        acc = torch.zeros(n, dtype=torch.float32, device=torch.device("cuda", dev))
        arrive = torch.zeros(max(slots, 0 if arrive is None else arrive.numel()),
                             dtype=torch.int32, device=acc.device)
        _scratch[dev] = (acc, arrive)
    return acc, arrive


def _launch(variant, ps, ms, vs, gs, ent_off, pre, n_used, offs, lrs, b1, b2, bc1, bc2,
            eps, grads_bf16=False, seed=0, lib=None, row_base=None, det=False, ptrs=None):
    """One launch of csrc/fused_adam.cu's ``variant`` (``lib``: the library
    of another copy of it with the same interface) on ``pre``'s binned
    entries (no counting).  ``row_base`` (a row shard's first row per
    level) or ``det`` (the sorted, deterministic sum) take the ``_ex`` entry
    points.  ``pre``'s work list splits its hot tiles over several CTAs
    unless ``det`` (each row summed in entry order, one CTA a tile).
    ``ptrs``: the tables' and gradients' data_ptr lists, where
    the caller has them.  Returns whether a kernel ran (some used head is
    non-empty)."""
    ex = row_base is not None or det
    name = _C_ENTRY[variant].replace("fused_adam_", "fused_adam_ex_") if ex else _C_ENTRY[variant]
    if lib is not None:
        fn = c_entry(lib, name)
    else:
        fn = _entries.get(name)
        if fn is None:
            fn = _entries[name] = c_entry(cuda_build.load("fused_adam"), name)
    L = len(offs)
    D = ps[0].shape[1]
    dev, stream, current = _stream(ps[0].device)
    work = (0, 1, 0, 0, 0, 0, 0)
    if not det and pre.chunk:
        E_max = pre.split_items.shape[0]
        acc, arrive = _split_scratch(dev, E_max, pre.tb * D)
        work = (pre.chunk, E_max, pre.split_off.data_ptr(), pre.split_items.data_ptr(),
                pre.n_split.data_ptr(), acc.data_ptr(), arrive.data_ptr())
    if ptrs is None:
        ptrs = [[t.data_ptr() for t in ts] for ts in (ps, ms, vs, gs)]
    P = ctypes.c_void_p * L
    args = (P(*ptrs[0]), P(*ptrs[1]), P(*ptrs[2]), P(*ptrs[3]),
            (ctypes.c_longlong * L)(*ent_off),
            pre.rows.data_ptr(), pre.order.data_ptr(), pre.tile_off.data_ptr(), D, pre.tb, L,
            (ctypes.c_longlong * L)(*offs), (ctypes.c_longlong * L)(*n_used),
            (ctypes.c_float * L)(*lrs), b1, b2, 1.0 - b1, 1.0 - b2,
            float(bc1), float(bc2), eps, int(bool(grads_bf16)), int(seed) & 0xFFFFFFFF, stream)
    if ex:
        args += ((ctypes.c_longlong * L)(*(row_base or [0] * L)), int(bool(det)))
    if current:
        err = fn(*args, *work)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, *work)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
    return any(n > 0 for n in n_used)


@torch.no_grad()
def _step(entry, ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
          n_used, b1, b2, eps, grads_bf16, sr_seed, pre, noise16, deterministic=False):
    """Both entry points: checks, then the plain version for CPU tensors or
    the prep (unless ``pre`` is given) and one kernel launch for CUDA
    tensors (counted under ``entry`` and the variant).  ``deterministic``
    sums each row's entries in the prep's order (the plain prep's, sorted
    by row and entry; a ``pre`` that is not sorted raises)."""
    variant = _check_tables(ps, ms, vs)
    device = ps[0].device
    if deterministic and pre is not None and not pre.sorted_by_row:
        # the deterministic sum reads each row's entries as one run: a prep
        # binned by atomics may split a row's entries into several
        raise ValueError("deterministic=True needs a prep sorted by row "
                         "(entry_prep_stack_plain), not csrc/entry_prep.cu's")
    if device.type == "cpu":
        return fused_adam_multi_plain(ps, ms, vs, rows_list, g_list, lr, bc1, bc2,
                                      lr_scales, n_used, b1, b2, eps, grads_bf16,
                                      sr_seed, pre, noise16)
    if device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda (or cpu), not {device}")
    if variant == "bf16p" and sr_seed is None:
        raise ValueError("bf16 tables need a per-step sr_seed")
    if noise16 is not None:
        raise ValueError("noise16 feeds the plain version only: the kernel draws its "
                         "stochastic-rounding bits from Philox keyed by sr_seed")
    _per_level(ps, rows_list, g_list)
    sizes, n_used, offs, lrs = _levels(ps, n_used, lr, lr_scales)
    D = ps[0].shape[1]
    ent_off = _entry_offsets(g_list, rows_list, D, device)
    ptrs = _check_aligned((("p", ps), ("m", ms), ("v", vs), ("grads", g_list)))
    if deterministic and pre is None:  # no work list: the sum in order never splits
        pre = entry_prep_stack_plain([r.reshape(1, -1) for r in rows_list], sizes, n_used,
                                     tile_rows(D), 0)
        pre = window_prep(pre, 0)
    pre = _prep_for(pre, rows_list, sizes, n_used, D, device)
    if _launch(variant, ps, ms, vs, g_list, ent_off, pre, n_used, offs, lrs, b1, b2, bc1, bc2,
               eps, grads_bf16, 0 if sr_seed is None else sr_seed, det=deterministic,
               ptrs=ptrs):
        LAUNCHES[entry + _SUFFIX[variant]] += 1
        LEVEL_STEPS[entry + _SUFFIX[variant]] += len(ps)
    return pre.dropped


def fused_adam_multi(ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
                     n_used=None, b1: float = 0.9, b2: float = 0.99,
                     eps: float = 1e-15, grads_bf16: bool = False,
                     sr_seed: Optional[int] = None, pre: Optional[EntryPrep] = None,
                     noise16=None, deterministic: bool = False):
    """Dense-Adam step on all levels' tables in ONE kernel launch (K2).

    ``ps``, ``ms``, ``vs`` are the per-level ``(C_l, D)`` tables;
    ``rows_list[l]`` level l's corner rows (any shape), ``g_list[l]`` the
    matching float32 gradients (``(..., D)``); ``lr_scales`` the per-level
    lr multipliers; ``n_used`` the per-level used heads (None = whole
    tables).  ``bc1``/``bc2`` are Adam's bias corrections for this step.
    ``grads_bf16`` rounds each gradient entry to bfloat16 before the sum.
    bf16 tables (``VARIANTS``) need ``sr_seed``, an integer that must vary
    per step (the trainer passes the iteration).  ``pre``: the
    :func:`entry_prep` of exactly these rows, sizes and heads.
    ``noise16``: see :func:`fused_adam_multi_plain` (CPU tensors only).
    ``deterministic``: every launch on the same entries gives the same bits
    (each row summed in entry order from a prep sorted by row: built here
    when ``pre`` is None, else ``pre.sorted_by_row`` must hold, as for
    :func:`entry_prep_stack_plain`'s, or it raises); the data-parallel
    replicas use it.
    Returns the dropped-entry count."""
    return _step("fused_adam_multi", ps, ms, vs, rows_list, g_list, lr, bc1, bc2,
                 lr_scales, n_used, b1, b2, eps, grads_bf16, sr_seed, pre, noise16,
                 deterministic)


def fused_adam(p, m, v, rows, grads, lr, bc1, bc2, n_used: Optional[int] = None,
               b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
               grads_bf16: bool = False, pre: Optional[EntryPrep] = None,
               deterministic: bool = False):
    """Dense-Adam step on one level's ``(C, D)`` table (K1).

    ``rows`` are corner rows (any shape), ``grads`` the matching ``(..., D)``
    float32 gradients (duplicates fine, trashbin row ``C - 1`` ignored).  p
    is float32, m and v float32 or bfloat16; bf16 tables take
    :func:`fused_adam_multi`, which carries the stochastic-rounding seed (as
    the JAX package's ``fused_adam_packed`` refuses them).
    ``deterministic``: see :func:`fused_adam_multi`.  Returns the
    dropped-entry count."""
    if p.dtype != torch.float32:
        raise TypeError(f"fused_adam takes float32 parameters, got {p.dtype}: bf16 "
                        "tables ride fused_adam_multi with an sr_seed")
    return _step("fused_adam", [p], [m], [v], [rows], [grads], lr, bc1, bc2,
                 [1.0], None if n_used is None else [n_used], b1, b2, eps,
                 grads_bf16, None, pre, None, deterministic)


def fused_adam_levels(ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
                      n_used=None, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                      grads_bf16: bool = False, pre: Optional[EntryPrep] = None,
                      deterministic: bool = False):
    """K1's per-level step on L levels: level l's ``(C_l, D)`` table takes
    :func:`fused_adam`'s step with its own entries and lr ``lr *
    lr_scales[l]``, as L :func:`fused_adam` calls (the JAX package's L
    ``fused_adam_packed`` calls, trainer.py:1330).

    On CPU tensors exactly those L calls, each through
    :func:`fused_adam_plain` (given a ``pre``, the plain step on it, which
    gives the same bits).  On CUDA tensors one prep of all L levels
    (``pre``: :func:`entry_prep` of these rows, sizes and heads, built here
    when None) and ONE launch of the kernel with each level's lr: a row's
    result depends only on its level's entries and lr, so it is the
    per-level launches' step (bit for bit on rows of at most one entry).
    Counted once under ``fused_adam`` (and the variant), with L levels in
    :data:`LEVEL_STEPS`.  f32 p only, as :func:`fused_adam`.  Returns the
    dropped-entry count."""
    if ps[0].dtype != torch.float32:
        raise TypeError(f"fused_adam_levels takes float32 parameters, got {ps[0].dtype}: "
                        "bf16 tables ride fused_adam_multi with an sr_seed")
    if ps[0].device.type == "cpu" and pre is None:
        _check_tables(ps, ms, vs)
        _per_level(ps, rows_list, g_list)
        sizes, n_used, _, lrs = _levels(ps, n_used, lr, lr_scales)
        dropped = torch.zeros((), dtype=torch.int64)
        for l in range(len(ps)):
            dropped = dropped + fused_adam_plain(ps[l], ms[l], vs[l], rows_list[l], g_list[l],
                                                 lrs[l], bc1, bc2, n_used[l], b1, b2, eps,
                                                 grads_bf16)
        return dropped
    return _step("fused_adam", ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
                 n_used, b1, b2, eps, grads_bf16, None, pre, None, deterministic)


# ------------------------------------------------------------------ row shards


def shard_geometry(shapes, n_shards: int) -> Tuple[Tuple[int, ...], int]:
    """The row split of per-level ``(C_l, D)`` tables over ``n_shards``
    (JAX ``shard_geometry``, adam_kernel.py:447, on the port's layout):
    each level's table is cut into ``n_shards`` contiguous blocks of ``C_l /
    n`` rows, rank k holding rows ``[k C_l / n, (k + 1) C_l / n)`` of every
    level, so no block straddles a level (the JAX package cuts the levels'
    concatenated 128-lane table into ``R_tot / n`` rows instead).  Returns
    (rows per level of a block, rows per tile of the kernel).  Raises
    ValueError when a level does not split evenly or a block's elements do
    not start on a group of 8 (the kernel's stochastic-rounding groups)."""
    n = int(n_shards)
    Ds = {int(D) for _, D in shapes}
    if n < 1 or len(Ds) != 1:
        raise ValueError(f"{n} shards of tables {list(shapes)}: one feature dim and n >= 1")
    D = Ds.pop()
    for C, _ in shapes:
        if int(C) % n or (int(C) // n * D) % 8:
            raise ValueError(f"a level of {C} rows of {D} does not split into {n} blocks "
                             "starting on groups of 8 elements")
    return tuple(int(C) // n for C, _ in shapes), tile_rows(D)


def shardable(shapes, n_shards: int) -> bool:
    """Can these tables row-shard evenly over ``n_shards`` (JAX
    ``shardable``, adam_kernel.py:494)?"""
    try:
        shard_geometry(shapes, n_shards)
        return True
    except ValueError:
        return False


def shard_row_base(shapes, n_shards: int, rank: int) -> List[int]:
    """Rank ``rank``'s first row of each level's whole table."""
    return [int(rank) * (int(C) // int(n_shards)) for C, _ in shapes]


def entry_prep_local(rows_loc: torch.Tensor, sizes_loc: Sequence[int], dim: int) -> EntryPrep:
    """The :class:`EntryPrep` of a row shard's entries (JAX
    ``entry_prep_local``, adam_kernel.py:503): ``rows_loc`` (..., M) holds
    each entry's row in the shard's blocks concatenated (level l's block
    starts at ``sum(sizes_loc[:l])``), -1 for a pad slot.  Every row of
    every block is covered by a tile (no used head).  A stable sort on any
    device, so each tile's entries come sorted by row and entry;
    ``order`` indexes the ``M``
    entries as given.  Leading dims stack batches (:func:`window_prep` takes
    one).  Raises ValueError on a row past the blocks."""
    sizes = tuple(int(c) for c in sizes_loc)
    total = sum(sizes)
    if total >= _SENTINEL:
        raise ValueError("shards of 2**31 - 1 rows or more are not supported")
    r = rows_loc.to(torch.int64)
    if r.numel() and int(r.max()) >= total:
        raise ValueError(f"a row {int(r.max())} lies past the shard's {total} rows")
    lead = r.shape[:-1]
    r = r.reshape(-1, r.shape[-1])
    tb = tile_rows(dim)
    rows_s, order = torch.sort(torch.where(r >= 0, r, _SENTINEL).to(torch.int32), dim=1,
                               stable=True)
    bounds, off = [], 0
    for C in sizes:
        bounds.append(torch.arange(0, C, tb, dtype=torch.int64, device=r.device) + off)
        off += C
    bounds.append(torch.tensor([_SENTINEL], dtype=torch.int64, device=r.device))
    b = torch.cat(bounds).to(torch.int32).expand(r.shape[0], -1).contiguous()
    tile_off = torch.searchsorted(rows_s, b).to(torch.int32)
    dropped = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
    T1 = tile_off.shape[1]
    return EntryPrep(rows_s.reshape(*lead, -1).contiguous(),
                     order.to(torch.int32).reshape(*lead, -1), tile_off.reshape(*lead, T1),
                     dropped.reshape(lead), sizes, sizes, tb, True)


def entry_prep_shard(rows_list: Sequence[torch.Tensor], sizes_loc: Sequence[int],
                     dim: int) -> EntryPrep:
    """The :class:`EntryPrep` of the entries a row shard receives in a live
    routing step (iid batches on row-sharded tables): ``rows_list[l]``
    level l's entries' rows in the shard's block of that level, -1 for a
    pad slot; entry i is the levels' entries concatenated (the order of
    :func:`fused_adam_shard`'s ``g_loc``).  Every row of every block is
    covered (no used head).  No block holds a trashbin row (the whole
    table's last row is a miss's, and misses do not route), so the pads
    alone are excluded, and they do not count as dropped.  On CUDA tensors
    one launch of csrc/entry_prep.cu, built per step (the windows' sorted
    :func:`entry_prep_local` costs a sort chain an iid step would pay
    every step); not sorted by row.  On CPU tensors
    :func:`entry_prep_local` of the rows in the blocks concatenated."""
    sizes = tuple(int(c) for c in sizes_loc)
    if len(rows_list) != len(sizes):
        raise ValueError("one rows tensor per level")
    device = rows_list[0].device
    if device.type == "cpu":
        off, glob = 0, []
        for r, C in zip(rows_list, sizes):
            r = r.reshape(-1).to(torch.int64)
            glob.append(torch.where(r >= 0, r + off, -1))
            off += C
        return entry_prep_local(torch.cat(glob), sizes, dim)
    if device.type != "cuda":
        raise ValueError(f"entry_prep_shard runs on cuda (or cpu), not {device}")
    if sum(sizes) >= _SENTINEL:
        raise ValueError("shards of 2**31 - 1 rows or more are not supported")
    return _prep_launch(rows_list, sizes, sizes, tile_rows(dim), trash=[0] * len(sizes),
                        stack=False)


def _shard_args(ps, ms, vs, rows_loc, g_loc, lr, lr_scales, row_base, pre):
    variant = _check_tables(ps, ms, vs)
    sizes, n_used, offs, lrs = _levels(ps, None, lr, lr_scales)
    D = int(ps[0].shape[1])
    if len(row_base) != len(ps) or any(int(b) * D % 8 for b in row_base):
        raise ValueError(f"row_base {list(row_base)}: one first row per level, on a group "
                         "of 8 elements")
    if g_loc.dtype != torch.float32 or g_loc.dim() != 2 or g_loc.shape[1] != D:
        raise ValueError(f"g_loc must be float32 (M, {D})")
    if rows_loc is None and pre is None:
        raise ValueError("pass the entries' rows_loc or their prep")
    if rows_loc is not None and rows_loc.reshape(-1).shape[0] != g_loc.shape[0]:
        raise ValueError(f"{rows_loc.numel()} rows but {g_loc.shape[0]} gradient rows")
    if pre is None:
        pre = entry_prep_local(rows_loc.reshape(-1), sizes, D)
    elif (pre.sizes != tuple(sizes) or pre.n_used != tuple(sizes) or pre.tb != tile_rows(D)
          or pre.rows.shape != (g_loc.shape[0],)):
        raise ValueError(f"pre was built for blocks {pre.sizes} and {tuple(pre.rows.shape)} "
                         f"entries; this step has {tuple(sizes)}, {g_loc.shape[0]}")
    return variant, sizes, offs, lrs, pre


@torch.no_grad()
def fused_adam_shard_plain(ps_loc, ms_loc, vs_loc, rows_loc, g_loc, lr, bc1, bc2, lr_scales,
                           row_base, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                           grads_bf16: bool = False, sr_seed: Optional[int] = None,
                           pre: Optional[EntryPrep] = None):
    """The plain torch version of :func:`fused_adam_shard` (any device):
    ``index_add_`` of the entries into each block and the dense-Adam step
    over the whole block, as :func:`fused_adam_multi_plain`; bf16 p rounds
    with the kernel's bits for the block's place in the whole table."""
    variant, sizes, offs, lrs, pre = _shard_args(ps_loc, ms_loc, vs_loc, rows_loc, g_loc, lr,
                                                 lr_scales, row_base, pre)
    if variant == "bf16p" and sr_seed is None:
        raise ValueError("bf16 tables need a per-step sr_seed")
    gs = g_loc.index_select(0, pre.order)
    _adam_levels_plain(variant, ps_loc, ms_loc, vs_loc, pre.rows, gs, sizes, offs, lrs, bc1,
                       bc2, b1, b2, eps, grads_bf16, sr_seed, None,
                       [int(b) for b in row_base])


@torch.no_grad()
def fused_adam_shard(ps_loc, ms_loc, vs_loc, rows_loc, g_loc, lr, bc1, bc2, lr_scales,
                     row_base, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                     grads_bf16: bool = False, sr_seed: Optional[int] = None,
                     pre: Optional[EntryPrep] = None):
    """Dense-Adam step over ONE row shard of the feature tables in one
    kernel launch: K2's row-sharded caller (JAX ``fused_adam_packed_shard``,
    adam_kernel.py:528, the per-device body of the routed row-sharded
    window update).

    ``ps_loc``, ``ms_loc``, ``vs_loc``: this shard's block of each level's
    table (:func:`shard_geometry`), ``row_base[l]`` the block's first row
    in level l's whole table (:func:`shard_row_base`).  ``g_loc`` (M, D)
    float32: the entries routed to this shard, in any order; ``rows_loc``
    (M,) their rows in the blocks concatenated, -1 for a pad slot (its
    gradient is never read), or None when ``pre`` is given.  ``pre``: :func:`entry_prep_local` of
    ``rows_loc`` (built here when None).  Every row of every block takes
    one step: rows no entry reached decay, and the headroom (zero moments,
    no entries) takes an exact no-op.  Each row's entries all live on one
    shard and its step is that of the unsharded K2, so the n shards' blocks
    concatenated equal one unsharded step (bf16 p too: the stochastic
    rounding is keyed by the element's place in the whole table).  On CPU
    tensors :func:`fused_adam_shard_plain`; on CUDA tensors one launch of
    csrc/fused_adam.cu (counted under ``fused_adam_multi_shard`` and the
    variant) or an error.  Each row lies on one shard, so no replica
    needs the deterministic sum: the launch takes the atomics."""
    device = ps_loc[0].device
    if device.type == "cpu":
        return fused_adam_shard_plain(ps_loc, ms_loc, vs_loc, rows_loc, g_loc, lr, bc1, bc2,
                                      lr_scales, row_base, b1, b2, eps, grads_bf16, sr_seed,
                                      pre)
    if device.type != "cuda":
        raise ValueError(f"fused_adam_shard runs on cuda (or cpu), not {device}")
    variant, sizes, offs, lrs, pre = _shard_args(ps_loc, ms_loc, vs_loc, rows_loc, g_loc, lr,
                                                 lr_scales, row_base, pre)
    if variant == "bf16p" and sr_seed is None:
        raise ValueError("bf16 tables need a per-step sr_seed")
    if g_loc.device != device or pre.rows.device != device or not g_loc.is_contiguous():
        raise ValueError("entries must be contiguous and lie on the tables' device")
    L = len(ps_loc)
    _check_aligned((("p", ps_loc), ("m", ms_loc), ("v", vs_loc), ("grads", [g_loc])))
    # one gradient buffer for all levels: the prep's order indexes it directly
    if _launch(variant, ps_loc, ms_loc, vs_loc, [g_loc] * L, [0] * L, pre, sizes, offs, lrs,
               b1, b2, bc1, bc2, eps, grads_bf16, 0 if sr_seed is None else sr_seed,
               row_base=[int(b) for b in row_base]):
        LAUNCHES["fused_adam_multi_shard" + _SUFFIX[variant]] += 1
