"""Windowed segmented sum + dense Adam: the kernel-study one-hot kernels.

Port of three TPU kernels of the JAX round's kernel studies, which compute
one function with variants:

* :func:`fused_adam_onehot` — K3, ``_fused_kernel`` via ``pallas_fused_adam``
  (``experiments/exp_fused_adam.py``): sorted narrow ``(M, 8)`` entries
  summed per packed row over each tile's entry window, then dense Adam.
* :func:`fused_adam_onehot_variant` — K4, ``make_kernel(tb, w, variant)``
  via ``fused`` (``experiments/exp_pallas_debug.py``): the same body over
  pre-built lane rows, in the six variants of :data:`VARIANTS`.
* :func:`fused_adam_onehot_copy` — K5, ``_kernel4`` via ``pallas4``
  (``experiments/exp_pallas_trainer.py`` ``main2``): K1's body (``dot_bf16``)
  in place, plus a copy of the new p in float32 or bfloat16.

All three launch the one CUDA kernel of ``csrc/onehot_adam.cu`` on CUDA
tensors and run :func:`onehot_adam_plain` on CPU tensors; there is no
fallback.  A ``(C, 8)`` table and its packed ``(R, 128)`` form
(``R = C / 16``) are one contiguous buffer on the card (``.view(-1, 128)``),
so no layout conversion is made anywhere.

The window is part of the function.  Tile ``t`` (``tb`` packed rows) sums
only the entries in ``[offs[t] w, offs[t] w + 2 w)`` whose packed row lies
in the tile; an entry of the tile outside that window is dropped, by the
kernel and by the plain version alike, as the TPU kernels drop it.
:func:`windows_ok` says whether a window set holds every entry; nothing
falls back when it does not.  ``prow_p`` must be ascending over its entries
with ``-1`` padding after them (as the programs build it, from sorted rows):
the kernel finds a row's entries by binary search.

Arithmetic as the TPU kernels' (b1 0.9, b2 0.99, eps 1e-15 unless given):
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
``p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)`` in float32.  K3 and K4
return new tensors (the TPU kernels are not aliased); K5 updates p, m, v in
place (``input_output_aliases={2: 0, 3: 1, 4: 2}``).  Helpers copy the JAX
scripts' input arithmetic: :func:`lane_rows`, :func:`hi_lo`,
:func:`padded_prow`, :func:`window_offsets`, :func:`windows_ok` and
:func:`choose_tiles`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_build

D = 8  # the studies' feature width
PACK = 128 // D  # corner rows per 128-lane packed row
B1, B2, EPS = 0.9, 0.99, 1e-15

# K4's variants (exp_pallas_debug.py:49-93), in the script's order
VARIANTS = ("copy", "sweep", "window", "onehot", "dot_bf16", "dot_hi")
# csrc/onehot_adam.cu enum Mode; "narrow" is K3
_MODE = {"copy": 0, "sweep": 1, "window": 2, "onehot": 3, "dot_bf16": 4, "dot_hi": 5,
         "narrow": 6}
_COPY = {torch.float32: 1, torch.bfloat16: 2}
_COPY_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# 2 w int32 window ids beside the kernel's 32 B of static shared memory in
# the 48 KB a launch takes without opting in (csrc/onehot_adam.cu)
_MAX_W = (48 * 1024 - 32) // 8

# launches of the CUDA kernel, by entry point (and variant or copy type);
# chip_smoke.py zeroes and reads them around the kernel-study path
LAUNCHES: Dict[str, int] = {
    "fused_adam_onehot": 0,
    **{f"fused_adam_onehot_{v}": 0 for v in VARIANTS},
    "fused_adam_onehot_copy_f32": 0, "fused_adam_onehot_copy_bf16": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ tile sizes

# the TPU kernel's VMEM budget for its working set, which sized its tiles
# (shine_mapping_tpu/ops/adam_kernel.py:909); K5's program sizes with it
_VMEM_BUDGET = 8 << 20


def _fit_tiles(R: int, M: int, R_dense: Optional[int] = None) -> Tuple[int, int]:
    """(tile rows, window block) for R packed rows and M entries spread over
    R_dense of them: the JAX package's ``_fit_tiles`` (adam_kernel.py:975)."""
    R_d = R if R_dense is None else max(min(R_dense, R), 1)
    tb = min(512, R)
    while R % tb:
        tb //= 2
    while True:
        exp = max(256, 4 * M * tb // R_d)
        w = 256
        while w < exp:
            w *= 2
        if 4 * tb * w + 2048 * w <= _VMEM_BUDGET or tb <= 16:
            return tb, w
        tb //= 2


def choose_tiles(C: int, D: int, M: int, n_used: Optional[int] = None) -> Tuple[int, int]:
    """The JAX package's ``choose_tiles`` (adam_kernel.py:995)."""
    R = C * D // 128
    R_dense = None
    if n_used is not None:
        R_dense = max(min(R, (n_used * D + 127) // 128), 1)
    return _fit_tiles(R, M, R_dense)


# ------------------------------------------------------------------ inputs


def padded_len(M: int, w: int) -> int:
    """Mpad: M rounded up to whole windows, plus one spare window."""
    return ((M + w - 1) // w) * w + w


def lane_rows(grads: torch.Tensor, rows: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Narrow ``(M, 8)`` gradients of corner rows ``rows`` -> ``(n, 128)``
    float32 lane rows (``n`` >= M, zero rows after M): entry k's values in
    lanes ``(rows[k] % 16) * 8 ...``, zeros elsewhere
    (exp_fused_adam.py:89-98)."""
    M = grads.shape[0]
    n = M if n is None else n
    lane = torch.arange(128, device=grads.device)
    mask = (lane[None, :] // D) == (rows.long() % PACK)[:, None]
    out = torch.zeros((n, 128), dtype=torch.float32, device=grads.device)
    out[:M] = torch.where(mask, grads.float().repeat(1, PACK), 0.0)
    return out


def hi_lo(g128: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 lane rows -> bfloat16 (hi, lo) with hi + lo ~ g
    (exp_pallas_debug.py:161-162)."""
    hi = g128.to(torch.bfloat16)
    return hi, (g128 - hi.float()).to(torch.bfloat16)


def padded_prow(prow: torch.Tensor, w: int) -> torch.Tensor:
    """Sorted packed rows ``(M,)`` -> ``(1, Mpad)`` int32, ``-1`` padded."""
    M = prow.shape[0]
    out = torch.full((1, padded_len(M, w)), -1, dtype=torch.int32, device=prow.device)
    out[0, :M] = prow
    return out


def _searchsorted(prow: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(prow.contiguous(), bounds.to(prow.dtype))


def window_offsets(prow: torch.Tensor, T: int, tb: int, w: int, Mpad: int) -> torch.Tensor:
    """Per-tile window block offsets ``(T,)`` int32 of sorted packed rows:
    ``min(searchsorted(prow, t tb) // w, Mpad // w - 2)``."""
    start = _searchsorted(prow, torch.arange(T, device=prow.device) * tb)
    return torch.clamp(start // w, max=Mpad // w - 2).to(torch.int32)


def windows_ok(prow: torch.Tensor, offs: torch.Tensor, tb: int, w: int) -> torch.Tensor:
    """0-dim bool: every tile's entries end inside its window,
    ``all(wstart[1:] <= offs w + 2 w)`` (exp_pallas_trainer.py:124)."""
    T = offs.shape[0]
    ws = _searchsorted(prow, torch.arange(1, T + 1, device=prow.device) * tb)
    return torch.all(ws <= offs.long() * w + 2 * w)


def window_inputs(rows_sorted: torch.Tensor, grads_sorted: torch.Tensor, C: int, tb: int,
                  w: int):
    """The study programs' kernel inputs from sorted corner rows and narrow
    gradients: ``(prow_p (1, Mpad) int32, g_hi, g_lo (Mpad, 128) bf16,
    offs (T,) int32)`` (exp_pallas_debug.py:151-164)."""
    M = rows_sorted.shape[0]
    prow = (rows_sorted // PACK).to(torch.int32)
    prow_p = padded_prow(prow, w)
    Mpad = prow_p.shape[1]
    g_hi, g_lo = hi_lo(lane_rows(grads_sorted, rows_sorted, Mpad))
    offs = window_offsets(prow, C * D // 128 // tb, tb, w, Mpad)
    return prow_p, g_hi, g_lo, offs


# ------------------------------------------------------------------ plain version


def _members(prow_p: torch.Tensor, offs: torch.Tensor, tb: int, w: int):
    """(entry index, packed row) of every entry inside its tile's window."""
    T = offs.shape[0]
    dev = prow_p.device
    j = offs.long()[:, None] * w + torch.arange(2 * w, device=dev)  # (T, 2w)
    r = prow_p.reshape(-1)[j].long()
    t0 = torch.arange(T, device=dev)[:, None] * tb
    keep = (r >= t0) & (r < t0 + tb)
    return j[keep], r[keep]


def _window_sum(prow_p, offs, tb, w, R, g):
    j, r = _members(prow_p, offs, tb, w)
    return torch.zeros((R, 128), dtype=torch.float32, device=g.device).index_add_(
        0, r, g[j].float())


@torch.no_grad()
def onehot_adam_plain(p128, m128, v128, prow_p, g_parts: Sequence[torch.Tensor], offs,
                      lr, bc1, bc2, tb: int, w: int, variant: str, b1: float = B1,
                      b2: float = B2, eps: float = EPS):
    """The plain torch version (any device) on packed ``(R, 128)`` float32
    tables: returns new ``(p, m, v)``.  ``g_parts`` are the window inputs:
    ``[g_hi, g_lo]`` (bf16 lane rows) for K4's variants, ``[g128]`` (f32
    lane rows) for ``variant="f32"`` (K3).  ``lr``/``bc1``/``bc2`` are floats
    or 0-dim tensors."""
    R = p128.shape[0]
    if variant == "copy":
        return p128.clone(), m128.clone(), v128.clone()
    zeros = torch.zeros((R, 128), dtype=torch.float32, device=p128.device)
    if variant == "sweep":
        g = zeros
    elif variant == "window":
        T = offs.shape[0]
        j = offs.long()[:, None] * w + torch.arange(2 * w, device=p128.device)
        touch = (g_parts[0][j].float().sum(dim=(1, 2))
                 + prow_p.reshape(-1)[j].float().sum(dim=1))
        g = zeros + torch.repeat_interleave(touch * 0.0, tb)[:, None]
    elif variant == "onehot":
        _, r = _members(prow_p, offs, tb, w)
        count = torch.zeros(R, dtype=torch.float32, device=p128.device).index_add_(
            0, r, torch.ones_like(r, dtype=torch.float32))
        g = count[:, None] * zeros
    elif variant == "dot_bf16":
        g = (_window_sum(prow_p, offs, tb, w, R, g_parts[0])
             + _window_sum(prow_p, offs, tb, w, R, g_parts[1]))
    elif variant == "dot_hi":
        g = _window_sum(prow_p, offs, tb, w, R, g_parts[0].float() + g_parts[1].float())
    elif variant == "f32":
        g = _window_sum(prow_p, offs, tb, w, R, g_parts[0])
    else:
        raise ValueError(f"unknown variant {variant!r}")
    m_new = b1 * m128 + (1.0 - b1) * g
    v_new = b2 * v128 + (1.0 - b2) * g * g
    p_new = p128 - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return p_new, m_new, v_new


# ------------------------------------------------------------------ checks


def _packed(t: torch.Tensor, name: str, shape=None) -> torch.Tensor:
    """A contiguous float32 table as its (R, 128) view."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if t.numel() % 128 or t.data_ptr() % 16:
        raise ValueError(f"{name} must hold whole 128-lane rows, 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    return t.view(-1, 128)


def _check_windows(R, tb, w, offs, prow_p, device):
    """Tile geometry: T = R / tb tiles (rows past T tb would stay unwritten,
    as in the TPU kernel, so R % tb != 0 raises) and windows that fit."""
    if tb < 1 or w < 1 or R % tb:
        raise ValueError(f"{R} packed rows are not whole tiles of {tb}")
    if w > _MAX_W:
        raise ValueError(f"window blocks of {w} entries exceed {_MAX_W}")
    T = R // tb
    if offs.dtype != torch.int32 or tuple(offs.shape) != (T,):
        raise ValueError(f"offs must be an int32 ({T},) tensor")
    Mpad = prow_p.shape[-1]
    if (prow_p.dtype != torch.int32 or tuple(prow_p.shape) != (1, Mpad)
            or Mpad % w or Mpad < 2 * w):
        raise ValueError(f"prow_p must be an int32 (1, Mpad) tensor, Mpad >= 2 w a "
                         f"multiple of w = {w}")
    for name, t in (("offs", offs), ("prow_p", prow_p)):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
    return T, Mpad


def _check_lanes(g_hi, g_lo, Mpad, device):
    for name, g in (("g_hi", g_hi), ("g_lo", g_lo)):
        if (g.dtype != torch.bfloat16 or tuple(g.shape) != (Mpad, 128)
                or not g.is_contiguous() or g.device != device):
            raise ValueError(f"{name} must be a contiguous bfloat16 ({Mpad}, 128) "
                             f"tensor on {device}")


def _scalars(scal, device):
    if scal.dtype != torch.float32 or scal.numel() < 3 or scal.device != device:
        raise ValueError(f"scal must be float32 [lr, bc1, bc2, ...] on {device}")
    s = scal.reshape(-1).contiguous()
    return s, s[0], s[1], s[2]


def _device(p):
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the one-hot kernels run on cuda (or cpu), not {p.device}")
    return p.device


# ------------------------------------------------------------------ kernel


def c_entry(lib: ctypes.CDLL) -> ctypes._CFuncPtr:
    """``lib.onehot_adam`` with its C signature declared: ``lib`` is the
    library of ``csrc/onehot_adam.cu`` or of another copy of it with the same
    interface."""
    fn = lib.onehot_adam
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_float] * 9
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_entry_fn = None  # csrc/onehot_adam.cu's onehot_adam, resolved at the first launch


def _launch(mode, pc_kind, p, m, v, po, mo, vo, pc, ids, g0, g1, offs, scal, lr, bc1,
            bc2, T, tb, w, n_ids, b1, b2, eps, fn=None):
    """One launch of csrc/onehot_adam.cu (``fn``: another build's
    :func:`c_entry`) on the current stream of ``p``'s device, not
    counted."""
    global _entry_fn
    if fn is None:
        if _entry_fn is None:
            _entry_fn = c_entry(cuda_build.load("onehot_adam"))
        fn = _entry_fn

    def ptr(t):
        return None if t is None else t.data_ptr()

    dev = p.get_device()
    args = (mode, pc_kind, ptr(p), ptr(m), ptr(v), ptr(po), ptr(mo), ptr(vo), ptr(pc),
            ptr(ids), ptr(g0), ptr(g1), ptr(offs), ptr(scal), float(lr), float(bc1),
            float(bc2), b1, b2, 1.0 - b1, 1.0 - b2, eps, 0.0, T, tb, w, n_ids,
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"onehot_adam kernel launch failed: CUDA error {err}")


def _k3_inputs(p, m, v, rows_sorted, grads_sorted, tb, w):
    """K3's checks and window prep: (shape, packed tables, T, prow, offs)."""
    shape = tuple(p.shape)
    if len(shape) != 2 or shape[1] != D:
        raise ValueError(f"tables must be (C, {D})")
    tabs = [_packed(t, n, shape) for t, n in ((p, "p"), (m, "m"), (v, "v"))]
    device = _device(p)
    M = rows_sorted.shape[0]
    if (rows_sorted.dtype != torch.int32 or rows_sorted.dim() != 1
            or rows_sorted.device != device):
        raise ValueError(f"rows_sorted must be an int32 (M,) tensor on {device}")
    if (grads_sorted.dtype != torch.float32 or tuple(grads_sorted.shape) != (M, D)
            or grads_sorted.device != device):
        raise ValueError(f"grads_sorted must be a float32 ({M}, {D}) tensor on {device}")
    R = tabs[0].shape[0]
    if tb < 1 or R % tb or not 1 <= w <= _MAX_W:
        raise ValueError(f"{R} packed rows are not whole tiles of {tb}, or w {w} is "
                         f"outside [1, {_MAX_W}]")
    prow = (rows_sorted // PACK).to(torch.int32)
    offs = window_offsets(prow, R // tb, tb, w, padded_len(M, w))
    return shape, tabs, R // tb, prow, offs


@torch.no_grad()
def fused_adam_onehot_plain(p, m, v, rows_sorted, grads_sorted, lr, bc1, bc2,
                            tb: int = 256, w: int = 256):
    """The plain torch version of :func:`fused_adam_onehot` (any device)."""
    shape, tabs, _, prow, offs = _k3_inputs(p, m, v, rows_sorted, grads_sorted, tb, w)
    prow_p = padded_prow(prow, w)
    g128 = lane_rows(grads_sorted, rows_sorted, prow_p.shape[1])
    out = onehot_adam_plain(*tabs, prow_p, [g128], offs, lr, bc1, bc2, tb, w, "f32")
    return tuple(t.view(shape) for t in out)


@torch.no_grad()
def fused_adam_onehot(p, m, v, rows_sorted, grads_sorted, lr, bc1, bc2, tb: int = 256,
                      w: int = 256):
    """K3: one dense-Adam step of ``(C, 8)`` float32 tables from sorted corner
    rows ``rows_sorted (M,)`` int32 (duplicates fine) and their narrow
    gradients ``grads_sorted (M, 8)`` float32, each tile summing its entries
    over its two ``w``-entry windows.  ``lr``, ``bc1``, ``bc2`` are floats.
    Returns new ``(p, m, v)`` of the tables' shape.  As
    ``pallas_fused_adam(p, m, v, rows_sorted, grads_sorted, lr, bc1, bc2, tb, w)``."""
    if p.device.type == "cpu":
        return fused_adam_onehot_plain(p, m, v, rows_sorted, grads_sorted, lr, bc1, bc2,
                                       tb, w)
    _, _, T, _, offs = _k3_inputs(p, m, v, rows_sorted, grads_sorted, tb, w)
    outs = [torch.empty_like(t) for t in (p, m, v)]
    # window slots past the M entries are absent to the kernel: no padding
    _launch(_MODE["narrow"], 0, p, m, v, *outs, None, rows_sorted.contiguous(),
            grads_sorted.contiguous(), None, offs, None, lr, bc1, bc2, T, tb, w,
            rows_sorted.shape[0], B1, B2, EPS)
    LAUNCHES["fused_adam_onehot"] += 1
    return tuple(outs)


def _lane_inputs(tabs, names, shape, prow_p, g_hi, g_lo, offs, scal, tb, w):
    """K4/K5 checks: (packed tables, T, Mpad, scal, lr, bc1, bc2)."""
    packed = [_packed(t, n, shape) for t, n in zip(tabs, names)]
    device = _device(tabs[0])
    T, Mpad = _check_windows(packed[0].shape[0], tb, w, offs, prow_p, device)
    _check_lanes(g_hi, g_lo, Mpad, device)
    return (packed, T, Mpad, *_scalars(scal, device))


def _variant_inputs(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb, w, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return _lane_inputs((p, m, v), "pmv", tuple(p.shape), prow_p, g_hi, g_lo, offs, scal,
                        tb, w)


@torch.no_grad()
def fused_adam_onehot_variant_plain(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb: int,
                                    w: int, variant: str):
    """The plain torch version of :func:`fused_adam_onehot_variant` (any device)."""
    tabs, _, _, _, lr, bc1, bc2 = _variant_inputs(p, m, v, prow_p, g_hi, g_lo, offs, scal,
                                                  tb, w, variant)
    out = onehot_adam_plain(*tabs, prow_p, [g_hi, g_lo], offs, lr, bc1, bc2, tb, w, variant)
    return tuple(t.view(p.shape) for t in out)


@torch.no_grad()
def fused_adam_onehot_variant(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb: int, w: int,
                              variant: str):
    """K4: ``variant`` (:data:`VARIANTS`) of the one-hot step on ``(C, 8)``
    float32 tables, over pre-built window inputs (:func:`window_inputs`):
    ``prow_p (1, Mpad)`` int32, ``g_hi``/``g_lo (Mpad, 128)`` bf16,
    ``offs (T,)`` int32, ``scal`` float32 ``[lr, bc1, bc2, ...]`` on the
    tables' device.  Returns new ``(p, m, v)``.  As
    ``fused(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb, w, variant)``."""
    if p.device.type == "cpu":
        return fused_adam_onehot_variant_plain(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb,
                                               w, variant)
    _, T, Mpad, s, _, _, _ = _variant_inputs(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb, w,
                                             variant)
    outs = [torch.empty_like(t) for t in (p, m, v)]
    _launch(_MODE[variant], 0, p, m, v, *outs, None, prow_p, g_hi, g_lo, offs, s, 0.0, 1.0,
            1.0, T, tb, w, Mpad, B1, B2, EPS)
    LAUNCHES[f"fused_adam_onehot_{variant}"] += 1
    return tuple(outs)


def _copy_inputs(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal, tb, w, copy_dtype):
    if copy_dtype not in _COPY:
        raise ValueError(f"copy_dtype must be float32 or bfloat16, got {copy_dtype}")
    if p128.dim() != 2 or p128.shape[1] != 128:
        raise ValueError("K5 takes packed (R, 128) tables")
    return _lane_inputs((p128, m128, v128), ("p128", "m128", "v128"), tuple(p128.shape),
                        prow_p, g_hi, g_lo, offs, scal, tb, w)


@torch.no_grad()
def fused_adam_onehot_copy_plain(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal, tb: int,
                                 w: int, copy_dtype=torch.float32, b1: float = B1,
                                 b2: float = B2, eps: float = EPS):
    """The plain torch version of :func:`fused_adam_onehot_copy` (any
    device), in place as the kernel."""
    _, _, _, _, lr, bc1, bc2 = _copy_inputs(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal,
                                            tb, w, copy_dtype)
    p_new, m_new, v_new = onehot_adam_plain(p128, m128, v128, prow_p, [g_hi, g_lo], offs, lr,
                                            bc1, bc2, tb, w, "dot_bf16", b1, b2, eps)
    p128.copy_(p_new)
    m128.copy_(m_new)
    v128.copy_(v_new)
    return p128, m128, v128, p_new.to(copy_dtype)


@torch.no_grad()
def fused_adam_onehot_copy(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal, tb: int,
                           w: int, copy_dtype=torch.float32, b1: float = B1,
                           b2: float = B2, eps: float = EPS):
    """K5: K1's step (``dot_bf16``) on packed ``(R, 128)`` float32 tables,
    IN PLACE, plus ``pc = p_new.to(copy_dtype)`` (float32 or bfloat16, round
    to nearest even) as a new tensor.  Inputs as
    :func:`fused_adam_onehot_variant`.  Returns ``(p128, m128, v128, pc)``.
    As ``pallas4(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal, copy_dtype)``."""
    if p128.device.type == "cpu":
        return fused_adam_onehot_copy_plain(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal,
                                            tb, w, copy_dtype, b1, b2, eps)
    _, T, Mpad, s, _, _, _ = _copy_inputs(p128, m128, v128, prow_p, g_hi, g_lo, offs, scal,
                                          tb, w, copy_dtype)
    pc = torch.empty(p128.shape, dtype=copy_dtype, device=p128.device)
    _launch(_MODE["dot_bf16"], _COPY[copy_dtype], p128, m128, v128, p128, m128, v128, pc,
            prow_p, g_hi, g_lo, offs, s, 0.0, 1.0, 1.0, T, tb, w, Mpad, b1, b2, eps)
    LAUNCHES[f"fused_adam_onehot_copy_{_COPY_NAME[copy_dtype]}"] += 1
    return p128, m128, v128, pc
