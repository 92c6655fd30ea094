"""``train_samples_per_s`` where it is read but not bounded: batch samples
of every step completed in the window over the window's host-clock seconds
(the window ends in a synchronise).  The street's runs spread by more than
the largest bound allows, with the host's speed, so there the rate is a
reading beside the cell's end-to-end metrics and not one of them."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["samples"] / rec["window_s"]
