"""Synchronised host seconds of the data phase (``data.dataset``: reading,
preprocessing and sampling every scan, growing the octree)."""


def read(rec):
    return rec["timers"].get("data")
