"""The yardstick's bounds against the kernel table's (PERF.md, section 6)."""

import pytest

from portbench import counting

FLAGSHIP = counting.Shapes(4096, 4, 16, 16, boxes=False)
BUP = counting.Shapes(4096, 2, 11, 6, boxes=True)


@pytest.mark.parametrize('bound,expected_ms', [
    (lambda: counting.step_bound_s(FLAGSHIP), 0.007938),
    (lambda: counting.step_bound_s(BUP), 0.004089),
    (lambda: counting.obs_bound_s(FLAGSHIP, packed=False), 0.006774),
    (lambda: counting.obs_bound_s(BUP, packed=True), 0.001519),
])
def test_bounds_match_the_kernel_table(bound, expected_ms):
    assert bound() * 1e3 == pytest.approx(expected_ms, abs=5e-7)


def test_bound_takes_the_larger_side():
    assert counting.bound_s(3.35e12) == pytest.approx(1.0)
    assert counting.bound_s(0, vector_ops=67e12, tensor_ops=989e12) == pytest.approx(2.0)
