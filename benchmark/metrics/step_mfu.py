"""The whole step's share of the card's peak, in %: roofline.py's least
time for one step's work (bytes or float32 operations, whichever bounds it)
over the unprofiled window's seconds a step.  It bounds every kernel's
gain, also once a later change takes a kernel off the step."""

import roofline


def read(rec):
    w = rec.get("work")
    peaks = roofline.peaks_of(rec.get("device_kind", ""))
    if not w or peaks is None or not rec.get("step_s"):
        return None
    least, _ = roofline.least_time(*roofline.step_work(w), peaks)
    return 100.0 * least / rec["step_s"]
