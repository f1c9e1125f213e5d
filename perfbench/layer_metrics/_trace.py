"""Helpers the readers share: the traced stretch of a record."""

from perfbench import device as dev


def stretch(record):
    """(records, t0, t1) of the traced stretch, or None."""
    tr = record.get("trace")
    if not tr:
        return None
    return tr["records"], tr["t0"], tr["t1"]
