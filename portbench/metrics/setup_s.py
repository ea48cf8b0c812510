"""Seconds from the process's start to the first timed unit: imports, the
kernel library's load (and, in a checkout's first run, its build), the
program's set-up from the seed and the warm-up units."""


def read(rec):
    return rec["setup_s"]
