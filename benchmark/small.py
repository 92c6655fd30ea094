"""Small sizes of the cells for the CPU tests (the card runs them whole):
``cpu_sizes/<cell>.json`` each, ``{"traffic": ..., "config": ...}`` merged
over the cell's own files (``harness.Cell``'s overrides)."""

import json
import os

SIZES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpu_sizes")


def _read(name):
    with open(os.path.join(SIZES, name)) as f:
        return json.load(f)


OVERRIDES = {f[:-len(".json")]: _read(f) for f in sorted(os.listdir(SIZES)) if f.endswith(".json")}
