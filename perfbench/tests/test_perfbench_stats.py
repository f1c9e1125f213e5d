"""The statistics over a window."""

import pytest

from perfbench.stats import rate


def test_a_rate_is_all_work_over_the_whole_window():
    assert rate(250 * 128, 10.0) == 3200.0
    with pytest.raises(ValueError):
        rate(1, 0.0)
