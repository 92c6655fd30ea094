"""Batch samples of every step completed in the window over the window's
host-clock seconds (the window ends in a synchronise)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["samples"] / rec["window_s"]
