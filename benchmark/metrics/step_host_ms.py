"""Host milliseconds a step: the ``step`` spans (``train.trainer.train_chunk``,
each step from its draw to its aux; a replayed step's draw, replay, K1
launch and aux copy) summed over the traced run's spans stretch, over its
steps.  That stretch runs after the window with tracing on and no profiler:
``run_cell``'s ``span_rounds`` (100) stretches of ``trace_steps`` (20)
steps, each ended by a synchronise, so that the host never waits on a full
launch queue and the spans hold the host's own work."""


def read(rec):
    sp = rec["spans"]
    t = sp["stretch"].get("step")
    return None if t is None else 1e3 * t / sp["stretch_steps"]
