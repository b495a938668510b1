"""The frozen tail arithmetic."""
import numpy as np
import pytest

from bench import tails


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 1.0])
def test_quantile_is_linear_interpolation(q):
    x = np.random.default_rng(0).exponential(size=37)
    assert tails.quantile(x.tolist(), q) == pytest.approx(
        float(np.percentile(x, 100 * q)))
    assert tails.quantile([], q) is None


def test_ttft_censors_at_the_window_end():
    due = {1: -1.0, 2: 0.5, 3: 2.0, 4: 9.5, 5: 10.0}
    first = {1: 0.2, 2: 1.5, 3: 11.0}
    # 1 is due before the window, 5 after it; 3's first token comes after
    # the end and 4 has none: both count their wait until the end
    assert tails.ttfts(due, first, 0.0, 10.0) == [1.0, 8.0, 0.5]


def test_gaps_end_inside_the_window():
    returns = {1: [-0.5, 0.25, 1.0], 2: [9.0, 10.0, 10.5]}
    assert tails.gaps(returns, 0.0, 10.0) == [0.75, 0.75, 1.0]

