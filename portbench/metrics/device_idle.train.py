"""Share of the traced stretch in which no kernel ran on the card.

1 - (union of the kernel intervals of the profiler's trace) / (the
stretch's wall time, sync to sync), in percent. Read from the raw kineto
events (`harness.Trace`), not from `key_averages`.
"""


def read(run):
    t = run.rec.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
