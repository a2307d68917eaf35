"""Set-up seconds: process start to the window's start (imports, data,
the program's set-up, warm-up and, in a checkout's first run, the kernels'
build), on the host clock."""


def read(rec):
    return rec.setup_s
