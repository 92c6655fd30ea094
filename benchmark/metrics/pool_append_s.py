"""Host seconds of the pool's append in set-up
(``data.dataset._append_pool``): the traced run's ``data.pool`` spans of
set-up, summed (one a frame, on the main thread)."""


def read(rec):
    return rec["spans"]["setup"].get("data.pool")
