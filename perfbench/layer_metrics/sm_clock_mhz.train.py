"""Mean SM clock (MHz) over nvidia-smi's samples during the window."""


def read(record):
    return record.get("clocks", {}).get("clocks.sm.mean")
