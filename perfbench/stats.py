"""Statistics the benchmark reports."""

from __future__ import annotations


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds
