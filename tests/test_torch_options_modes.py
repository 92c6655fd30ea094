"""The port's other update modes with the new loss terms against the JAX
package, beyond its flag matrix: lazy Adam alone and with the semantic and
time-conditioned terms, dense autodiff Adam with the eikonal and semantic
terms, a decimated semantic NLL on K1, the NeuS rendering loss with
consistency, and SGD with consistency and normals.  Setup and tolerances:
tests/test_torch_options.py.
"""

import pytest

from tests.test_torch_options import EXTRA, _one_thread, check_combo, combo_ids  # noqa: F401


@pytest.mark.parametrize("combo", EXTRA, ids=combo_ids(EXTRA))
def test_update_mode_combo_matches_jax(combo):
    check_combo(combo)
