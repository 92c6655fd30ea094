"""The update kernel's (csrc/fused_adam.cu, ``fused_adam_kernel``) share of
its roofline, in %: the least time of the step's update (roofline.py's
``update_work`` over the cell's used rows and found entries a step) over the
kernel's device time a step in the trace."""

import roofline


def read(rec):
    tr, w = rec.get("trace"), rec.get("work")
    peaks = roofline.peaks_of(rec.get("device_kind", ""))
    if not tr or not w or peaks is None:
        return None
    t = sum(s for name, s in tr["by_name"].items() if "fused_adam_kernel" in name)
    if t <= 0:
        return None
    least, _ = roofline.least_time(*roofline.update_work(w["used_rows"], w["found_entries"],
                                                         w["dim"]), peaks)
    return 100.0 * least / (t / tr["steps"])
