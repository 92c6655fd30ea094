"""The yardstick of the roofline shares: the card's published peaks, and the
least bytes and operations of the training step, counted from its shapes.

Each input is counted read once and each output written once, whatever a
kernel reads again, and only what these inputs need: the corners that the
batch's samples find, not the trashbin's entries of a miss.
"""

from __future__ import annotations

# NVIDIA's data sheet, SXM part, at the full 700 W power limit: HBM3
# bandwidth and float32 outside the tensor cores (the step computes in float32
# with TF32 off)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_of(kind: str):
    return PEAKS.get(kind)


def least_time(nbytes: float, flops: float, peaks: dict):
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes, t_ops = nbytes / peaks["bytes_per_s"], flops / peaks["f32_flops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def update_work(n_rows: float, entries: float, dim: int, p_bytes: int = 4, m_bytes: int = 4):
    """Dense Adam over ``n_rows`` table rows of ``dim`` lanes fed by
    ``entries`` gradient entries: p, m and v of every row read and written,
    each entry's int32 row and float32 gradient read; ~13 float32 operations
    a table element, one an entry element (its sum).  (bytes, flops)"""
    elems = n_rows * dim
    nbytes = 2 * (p_bytes + 2 * m_bytes) * elems + entries * (4 + 4 * dim)
    return nbytes, 13 * elems + entries * dim


def mlp_flops(dims) -> int:
    """Multiply-adds of one sample's forward through layers ``dims``, as flops."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def step_work(w: dict):
    """(bytes, flops) of one training step of the work summary ``w``:

    * the batch's fields (coordinate, label, weight, time: 24 bytes a sample);
    * per level, the samples' 8 corner rows (int32) and found flags from the
      pool's lookups, the found corners' feature rows gathered, and their
      gradient entries written;
    * the update (:func:`update_work`) over every used row;
    * flops: per level the 8-corner interpolation (2 * 8 * D a sample), the
      decoder's forward F, its backward 2F, and with the eikonal term the
      input-gradient graph F and its backward 2F."""
    bs, L, D, M = w["bs"], w["levels"], w["dim"], w["found_entries"]
    nbytes = bs * 24 + bs * L * (8 * 4 + 1) + 2 * M * D * 4
    ub, uf = update_work(w["used_rows"], M, D)
    f = mlp_flops(w["decoder_dims"])
    per_sample = L * 2 * 8 * D + (6 if w["eikonal"] else 3) * f
    return nbytes + ub, bs * per_sample + uf
