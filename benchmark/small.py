"""Small sizes of the cells for the CPU tests (the card runs them whole):
``cpu_sizes/<cell>.json`` each, ``{"traffic": ..., "config": ...}`` merged
over the cell's own files (``harness.Cell``'s overrides)."""

import json
import os


def overrides(here: str = os.path.dirname(os.path.abspath(__file__))) -> dict:
    """``{cell: sizes}`` of every ``<here>/cpu_sizes/*.json``."""
    sizes = os.path.join(here, "cpu_sizes")
    out = {}
    for f in sorted(os.listdir(sizes)):
        if f.endswith(".json"):
            with open(os.path.join(sizes, f)) as fh:
                out[f[:-len(".json")]] = json.load(fh)
    return out


OVERRIDES = overrides()
