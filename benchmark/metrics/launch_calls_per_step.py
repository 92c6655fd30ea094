"""Launch calls a step: the runtime and driver API calls with ``Launch`` in
their names (cudaLaunchKernel, cuLaunchKernel, cudaGraphLaunch, ...) among
the profiler's host events, over the traced steps."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_ops"]:
        return None
    return tr["launches"] / tr["steps"]
