"""Queries answered in the window over the window's seconds: all the work
over all the time, on the host clock."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return rec.answered / rec.window_s
