"""Process start to the first timed step: writing the scans, the data phase,
the upload, the pool's lookups, the three checked steps and the warm chunk
(on a first run in a checkout, the kernels' nvcc builds)."""


def read(rec):
    return rec["setup_s"]
