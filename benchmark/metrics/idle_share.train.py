"""Share of the traced stretch's wall time in which no kernel ran on the
card (the union of the profiler's kernel intervals), in percent."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
