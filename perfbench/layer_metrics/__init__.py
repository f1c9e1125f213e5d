"""One reader per per-layer metric, in a file named after the metric:
``read(record) -> float or None``. ``record`` is the driver's record of
the run (``drivers/*.py``); a reader that finds nothing to read returns
None and the metric is left out of the line."""
