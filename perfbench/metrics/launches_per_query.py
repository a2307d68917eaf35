"""Kernel launches the port's wrappers counted (``kernels.LAUNCHES``, graph
replays included) over the window, per answered query."""


def read(rec):
    launches = rec.counters.get("launches")
    if not rec.answered or launches is None:
        return None
    return sum(launches.values()) / rec.answered
