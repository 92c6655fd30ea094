"""Synchronised host seconds of ``train.trainer.precompute_pool_lookups``
over the device pool."""


def read(rec):
    return rec["timers"].get("precompute")
