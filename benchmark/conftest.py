"""pytest settings of the benchmark's own tests (run them with
``python -m pytest benchmark``): the ``cuda`` marker of tests that need the
card, and the benchmark's folder on the import path."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); skips without one")
