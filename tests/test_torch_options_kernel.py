"""The second half of the JAX flag matrix against the port: the kernel update
(K1 / K2's plain versions on the CPU) with fused levels, sorted batches,
bf16 moments and tables, per-level and fused epoch windows with the
eikonal, semantic, time-conditioned, projective-correction and normal
terms, and the ray loss.  Setup and tolerances: tests/test_torch_options.py.
"""

import pytest

from tests.test_torch_options import COMBOS, _one_thread, check_combo, combo_ids  # noqa: F401


@pytest.mark.parametrize("combo", COMBOS[12:], ids=combo_ids(COMBOS[12:]))
def test_flag_combo_matches_jax(combo):
    check_combo(combo)
