"""Seconds from the process's start to the first timed round (host clock)."""


def read(rec):
    return rec["setup_s"]
