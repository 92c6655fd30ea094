"""The caching allocator's peak of allocated device memory over set-up and
the window (``torch.cuda.max_memory_allocated``), GiB."""


def read(rec):
    peak = rec.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
