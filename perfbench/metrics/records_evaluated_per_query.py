"""The program's ``records_evaluated`` (the sum of count(D) over atom
applications, the planners' cost) over the window, per answered query."""


def read(rec):
    if not rec.answered or "records_evaluated" not in rec.counters:
        return None
    return rec.counters["records_evaluated"] / rec.answered
