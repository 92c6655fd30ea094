"""Fused scatter + dense-Adam step on the feature tables.

Port of the TPU kernels of ``shine_mapping_tpu/ops/adam_kernel.py``:

* :func:`fused_adam`       — one level's ``(C, D)`` table; replaces ``_kernel``
  (K1, reached by ``fused_adam_packed``).
* :func:`fused_adam_multi` — all levels' ``(C_l, D)`` tables in one launch,
  each level with its own lr; replaces ``_kernel_multi`` (K2, reached by
  ``fused_adam_packed_multi`` and ``fused_adam_packed_multi_pre``, which run
  on the levels' tables concatenated; here the kernel takes one base pointer
  per level, so the tables stay where they are).

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
sorted — is an :class:`EntryPrep` (:func:`entry_prep`).  A caller whose
batches are known in advance (the trainer's epoch windows) computes it once
per batch and passes it as ``pre=``, so the step skips the sort.

All functions update ``p``, ``m``, ``v`` in place.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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
    "fused_adam": 0, "fused_adam_bf16m": 0,
    "fused_adam_multi": 0, "fused_adam_multi_bf16m": 0, "fused_adam_multi_bf16p": 0,
}

MAX_LEVELS = 16  # csrc/fused_adam.cu MAX_LEVELS
_SENTINEL = 2 ** 31 - 1  # sorts past every row; no tile covers it


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    for p, m, v in zip(ps, ms, vs):
        key = (p.dtype, m.dtype)
        if m.dtype != v.dtype or key not in VARIANTS:
            raise TypeError(
                f"fused Adam takes p/m/v as float32/float32/float32, "
                f"float32/bfloat16/bfloat16 or bfloat16/bfloat16/bfloat16, got "
                f"{p.dtype}/{m.dtype}/{v.dtype}")
        variants.add(VARIANTS[key])
        for name, t in (("p", p), ("m", m), ("v", v)):
            if t.dim() != 2 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous (rows, D) tensor")
            if t.shape != p.shape or t.device != p.device:
                raise ValueError("p, m and v must share shape and device")
        if p.shape[1] != ps[0].shape[1] or p.device != ps[0].device:
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


class EntryPrep(NamedTuple):
    """What a step needs of its entries' rows alone (no gradients).

    rows:    (M,) int32 — the entries' GLOBAL rows (level l's row r is
             ``sum(sizes[:l]) + r``), ascending; trashbin entries and
             entries past a used head carry a sentinel past every row
    order:   (M,) int32 — sorted entry j is entry ``order[j]`` of the
             levels' entries concatenated (a stable sort)
    dropped: () int64 — entries past a used head (trashbin rows excluded)
    sizes, n_used: the per-level table rows and used heads it was built for
    """

    rows: torch.Tensor
    order: torch.Tensor
    dropped: torch.Tensor
    sizes: Tuple[int, ...]
    n_used: Tuple[int, ...]


def entry_prep(rows_list: Sequence[torch.Tensor], sizes: Sequence[int],
               n_used: Optional[Sequence[int]] = None) -> EntryPrep:
    """The :class:`EntryPrep` of per-level corner rows ``rows_list[l]`` (any
    shape, int32/int64) for tables of ``sizes[l]`` rows with used heads
    ``n_used`` (None = whole tables).  The port's counterpart of
    ``entry_prep_lanes`` / ``entry_prep_multi`` (adam_kernel.py:940, :307):
    the card needs no tile windows, so it is the sort alone."""
    return window_prep(entry_prep_stack([r.reshape(1, -1) for r in rows_list],
                                        sizes, n_used), 0)


def entry_prep_stack(rows_list: Sequence[torch.Tensor], sizes: Sequence[int],
                     n_used: Optional[Sequence[int]] = None) -> EntryPrep:
    """:func:`entry_prep` of W batches at once: ``rows_list[l]`` is level
    l's rows of every batch, ``(W, ...)``.  Returns an EntryPrep whose rows
    and order are ``(W, M)`` and dropped ``(W,)``; :func:`window_prep` takes
    batch w's.  One batched sort for all W (the trainer's epoch windows)."""
    sizes = tuple(int(c) for c in sizes)
    n_used = sizes if n_used is None else tuple(int(n) for n in n_used)
    if len(rows_list) != len(sizes) or len(n_used) != len(sizes):
        raise ValueError("one rows tensor, size and used head per level")
    if any(not 0 <= n <= C for n, C in zip(n_used, sizes)):
        raise ValueError(f"n_used {n_used} must lie in [0, C_l] for sizes {sizes}")
    if sum(sizes) >= _SENTINEL:
        raise ValueError("tables of 2**31 - 1 rows or more in all are not supported")
    device = rows_list[0].device
    W = rows_list[0].shape[0]
    rows_g = []
    dropped = torch.zeros(W, dtype=torch.int64, device=device)
    off = 0
    for rows, C, nu in zip(rows_list, sizes, n_used):
        if rows.dtype not in (torch.int32, torch.int64):
            raise TypeError("rows must be int32/int64")
        if rows.device != device or rows.shape[0] != W:
            raise ValueError("all levels' rows must lie on one device, W batches each")
        r = rows.reshape(W, -1).to(torch.int64)
        trash = r == C - 1
        inside = (r >= 0) & (r < nu) & ~trash
        dropped = dropped + (~inside & ~trash).sum(dim=1)
        rows_g.append(torch.where(inside, r + off, _SENTINEL).to(torch.int32))
        off += C
    rows_s, order = torch.sort(torch.cat(rows_g, dim=1), dim=1, stable=True)
    return EntryPrep(rows_s.contiguous(), order.to(torch.int32), dropped, sizes, n_used)


def window_prep(pre: EntryPrep, w: int) -> EntryPrep:
    """Batch ``w``'s EntryPrep of a stack (:func:`entry_prep_stack`)."""
    return EntryPrep(pre.rows[w], pre.order[w], pre.dropped[w], pre.sizes, pre.n_used)


def _prep_for(pre, rows_list, sizes, n_used, device):
    """``pre``, checked against this call, or a fresh one."""
    M = sum(int(r.numel()) for r in rows_list)
    if pre is None:
        if any(r.device != device for r in rows_list):
            raise ValueError("entries must lie on the tables' device")
        return entry_prep(rows_list, sizes, n_used)
    if (pre.sizes != tuple(sizes) or pre.n_used != tuple(n_used)
            or pre.rows.shape[0] != M or pre.rows.device != device):
        raise ValueError(
            f"pre was built for sizes {pre.sizes}, used heads {pre.n_used} and "
            f"{pre.rows.shape[0]} entries on {pre.rows.device}; this step has "
            f"{tuple(sizes)}, {tuple(n_used)}, {M} on {device}")
    return pre


def _sorted_grads(pre: EntryPrep, g_list, D: int) -> torch.Tensor:
    """The levels' (…, D) float32 gradients concatenated, in ``pre``'s
    order: (M, D), contiguous."""
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

    With bf16 p the stochastic rounding draws its noise from a
    ``torch.Generator`` seeded with ``sr_seed`` (one draw over each level's
    whole table, so an element's bits do not depend on ``n_used``), or takes
    ``noise16[l]`` (level l's 16-bit noise, ``C_l * D`` elements in row-major
    order) from the caller: a seam that lets a test feed the JAX package's
    bits."""
    variant = _check_tables(ps, ms, vs)
    _per_level(ps, rows_list, g_list)
    sizes, n_used, offs, lrs = _levels(ps, n_used, lr, lr_scales)
    if variant == "bf16p" and sr_seed is None:
        raise ValueError("bf16 tables need a per-step sr_seed")
    device, D = ps[0].device, ps[0].shape[1]
    pre = _prep_for(pre, rows_list, sizes, n_used, device)
    gs = _sorted_grads(pre, g_list, D)
    if grads_bf16:
        gs = gs.to(torch.bfloat16).to(torch.float32)
    gen = None
    if variant == "bf16p" and noise16 is None:
        gen = torch.Generator(device=device).manual_seed(int(sr_seed))
    for l, (p, m, v, nu, off, lr_l) in enumerate(zip(ps, ms, vs, n_used, offs, lrs)):
        if gen is not None:  # drawn for every level, used head or not
            noise = torch.randint(0, 1 << 16, p.shape, generator=gen, device=device,
                                  dtype=torch.int32)
        if nu == 0:
            continue
        sel = (pre.rows >= off) & (pre.rows < off + nu)
        gl = torch.zeros((nu, D), dtype=torch.float32, device=device).index_add_(
            0, (pre.rows[sel] - off).to(torch.int64), gs[sel])
        m_new = b1 * m[:nu].float() + (1.0 - b1) * gl
        v_new = b2 * v[:nu].float() + (1.0 - b2) * gl * gl
        p_new = p[:nu].float() - lr_l * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if variant == "bf16p":
            if noise16 is not None:
                noise = noise16[l].reshape(-1)[: p.numel()].reshape(p.shape)
            p[:nu] = sr_round_bf16_plain(p_new, noise[:nu])
        else:
            p[:nu] = p_new
        m[:nu] = m_new  # to bf16 moments: round to nearest even
        v[:nu] = v_new
    return pre.dropped


def fused_adam_plain(p, m, v, rows, grads, lr, bc1, bc2, n_used=None,
                     b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                     grads_bf16: bool = False, pre: Optional[EntryPrep] = None):
    """The plain torch version of :func:`fused_adam` (any device): the
    multi-level plain version with one level."""
    return fused_adam_multi_plain(
        [p], [m], [v], [rows], [grads], lr, bc1, bc2, [1.0],
        None if n_used is None else [n_used], b1, b2, eps, grads_bf16, pre=pre)


# ------------------------------------------------------------------ kernel


def _launch(variant, ps, ms, vs, rows_s, g_s, n_used, offs, lrs, b1, b2, bc1, bc2,
            eps, grads_bf16=False, seed=0):
    """One launch of csrc/fused_adam.cu's ``variant`` on sorted entries (no
    counting).  Returns whether a kernel ran (some used head is non-empty)."""
    lib = cuda_build.load("fused_adam")
    fn = getattr(lib, _C_ENTRY[variant])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 3 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong)] * 2
                       + [ctypes.POINTER(ctypes.c_float)]
                       + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    L = len(offs)

    def ptrs(ts):
        return (ctypes.c_void_p * L)(*[t.data_ptr() for t in ts])

    with torch.cuda.device(ps[0].device):
        stream = torch.cuda.current_stream(ps[0].device).cuda_stream
        err = fn(ptrs(ps), ptrs(ms), ptrs(vs), rows_s.data_ptr(), g_s.data_ptr(),
                 rows_s.shape[0], ps[0].shape[1], L,
                 (ctypes.c_longlong * L)(*offs), (ctypes.c_longlong * L)(*n_used),
                 (ctypes.c_float * L)(*lrs), b1, b2, 1.0 - b1, 1.0 - b2,
                 float(bc1), float(bc2), eps, int(bool(grads_bf16)),
                 int(seed) & 0xFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
    return sum(n > 0 for n in n_used) > 0


@torch.no_grad()
def _step(entry, ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
          n_used, b1, b2, eps, grads_bf16, sr_seed, pre, noise16):
    """Both entry points: checks, then the plain version for CPU tensors or
    one kernel launch for CUDA tensors (counted under ``entry`` and the
    variant)."""
    variant = _check_tables(ps, ms, vs)
    device = ps[0].device
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
    pre = _prep_for(pre, rows_list, sizes, n_used, device)
    g_s = _sorted_grads(pre, g_list, ps[0].shape[1])
    if _launch(variant, ps, ms, vs, pre.rows, g_s, n_used, offs, lrs, b1, b2, bc1, bc2,
               eps, grads_bf16, 0 if sr_seed is None else sr_seed):
        LAUNCHES[entry + _SUFFIX[variant]] += 1
    return pre.dropped


def fused_adam_multi(ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales,
                     n_used=None, b1: float = 0.9, b2: float = 0.99,
                     eps: float = 1e-15, grads_bf16: bool = False,
                     sr_seed: Optional[int] = None, pre: Optional[EntryPrep] = None,
                     noise16=None):
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
    Returns the dropped-entry count."""
    return _step("fused_adam_multi", ps, ms, vs, rows_list, g_list, lr, bc1, bc2,
                 lr_scales, n_used, b1, b2, eps, grads_bf16, sr_seed, pre, noise16)


def fused_adam(p, m, v, rows, grads, lr, bc1, bc2, n_used: Optional[int] = None,
               b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
               grads_bf16: bool = False, pre: Optional[EntryPrep] = None):
    """Dense-Adam step on one level's ``(C, D)`` table (K1).

    ``rows`` are corner rows (any shape), ``grads`` the matching ``(..., D)``
    float32 gradients (duplicates fine, trashbin row ``C - 1`` ignored).  p
    is float32, m and v float32 or bfloat16; bf16 tables take
    :func:`fused_adam_multi`, which carries the stochastic-rounding seed (as
    the JAX package's ``fused_adam_packed`` refuses them).  Returns the
    dropped-entry count."""
    if p.dtype != torch.float32:
        raise TypeError(f"fused_adam takes float32 parameters, got {p.dtype}: bf16 "
                        "tables ride fused_adam_multi with an sr_seed")
    return _step("fused_adam", [p], [m], [v], [rows], [grads], lr, bc1, bc2,
                 [1.0], None if n_used is None else [n_used], b1, b2, eps,
                 grads_bf16, None, pre, None)
