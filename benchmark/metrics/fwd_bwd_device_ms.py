"""Device milliseconds a step of every operation but the update kernel
(csrc/fused_adam.cu) and its prep (csrc/entry_prep.cu): the lookups'
gathers, the interpolation, the decoder, the loss and its second-order
backward, the decoders' Adam."""

UPDATE = ("fused_adam_kernel", "prep_bin_kernel", "prep_scan_kernel", "prep_scatter_kernel")


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_ops"]:
        return None
    t = sum(s for name, s in tr["by_name"].items() if not any(u in name for u in UPDATE))
    return 1e3 * t / tr["steps"]
