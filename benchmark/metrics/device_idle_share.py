"""1 - device busy time a step / step time, in %.  Busy: the union of the
kernels', copies' and memsets' intervals in the profiler's trace over the
traced steps; step time: the unprofiled window's seconds a step."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_ops"] or not rec.get("step_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / rec["step_s"])
