"""The reduction of a profiled stretch: busy time as the union of the
device operations' intervals, the idle gaps and their host operations."""

import pytest

from portbench.tracing import Trace, union


def test_union_counts_overlaps_once():
    assert union([('a', 0, 10), ('b', 5, 12), ('c', 20, 25), ('d', 21, 22)]) == [(0, 12), (20, 25)]


def test_idle_share_and_breakdown():
    trace = Trace(ops=[('k1', 100, 110), ('k2', 105, 130), ('k1', 150, 170)],
                  host=[('cudaGraphLaunch', 90, 140), ('sync', 140, 200), ('outer', 0, 200)],
                  start_us=100, window_us=100, work=4)
    assert trace.busy_us() == 50
    assert trace.idle_share() == pytest.approx(0.5)
    assert trace.gaps() == [(130, 150), (170, 200)]
    b = trace.breakdown()
    assert b['device_ops'] == [['k1', pytest.approx(30e-6)], ['k2', pytest.approx(25e-6)]]
    # Each gap goes to the host operation that overlapped it most, the
    # innermost of equals: 130-150 to the outer one (20 us against 10 and
    # 10), 170-200 to the sync (30 us, as the outer one, but shorter).
    assert dict(b['idle_gaps']) == {'outer': pytest.approx(20e-6), 'sync': pytest.approx(30e-6)}
