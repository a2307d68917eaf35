"""Device time a query costs, in milliseconds: the time in the window in
which an operation of the run ran on the card (kernels and copies, from the
profiler's trace) over the queries answered in it."""


def read(rec):
    t = rec.trace
    if not t or not rec.answered or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / rec.answered
