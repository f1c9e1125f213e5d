"""Seconds of the program's first call on the host clock, ended by a
synchronise: the train step's eager warm-up step and capture(s)."""


def read(record):
    return record["capture_s"]
