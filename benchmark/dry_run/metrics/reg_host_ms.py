"""Host milliseconds a step of the stand-in's regularizer term: the
``step.reg`` spans summed over the traced run's spans stretch, over its
steps."""


def read(rec):
    sp = rec["spans"]
    t = sp["stretch"].get("step.reg")
    return None if t is None else 1e3 * t / sp["stretch_steps"]
