"""A profiled stretch of a run, reduced to what the per-layer metrics and
the result's ``device`` and ``breakdown`` read.

The stretch runs under ``torch.profiler`` (host and CUDA activity) between
two synchronizations, inside a marker whose span on the trace's clock is
the traced window. Busy time is the union of the device operations'
intervals inside it (kernels, copies and sets, overlapping ones counted
once); the idle gaps are the stretches of the window that no operation
covers, each named by the host operation that overlapped it most.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

MARK = 'portbench.stretch'
#: A name's characters kept in the breakdown (kernel names run to thousands).
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    #: (name, start_us, end_us) of every device operation in the window.
    ops: list
    #: (name, start_us, end_us) of the host's operations in the window.
    host: list
    #: The window's start and length on the trace's clock.
    start_us: float
    window_us: float
    #: Units of work (env steps, updates) the stretch ran.
    work: int

    def busy_us(self) -> float:
        return sum(e - s for s, e in union(self.ops))

    def idle_share(self) -> float:
        return 1.0 - self.busy_us() / self.window_us

    def gaps(self) -> list[tuple[float, float]]:
        out, cursor = [], self.start_us
        for s, e in union(self.ops):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.start_us + self.window_us:
            out.append((cursor, self.start_us + self.window_us))
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for name, s, e in self.ops:
            by_op[name] += (e - s) / 1e6
        # Each gap goes to the host operation that overlapped it most (the
        # innermost of equals).
        by_host = collections.Counter()
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host] or [0.0])
        he = np.array([h[2] for h in self.host] or [0.0])
        tie = (he - hs) * 1e-9
        for gs, ge in self.gaps():
            overlap = np.minimum(he, ge) - np.maximum(hs, gs)
            i = int(np.argmax(overlap - tie))
            by_host[names[i] if names and overlap[i] > 0 else 'none'] += (ge - gs) / 1e6
        return {'device_ops': [[n[:NAME_CHARS], v] for n, v in by_op.most_common(top)],
                'idle_gaps': [[n[:NAME_CHARS], v] for n, v in by_host.most_common(top)]}

    def named(self, predicate) -> list:
        return [op for op in self.ops if predicate(op[0])]


def union(intervals) -> list[tuple[float, float]]:
    """The intervals' union, as sorted disjoint (start, end) pairs."""
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def profile(fn, work: int) -> Trace:
    """Run ``fn()`` under the profiler; ``work`` units of work in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    mark = next(e for e in events if e.name == MARK and e.device_type == DeviceType.CPU)
    w0, w1 = mark.time_range.start, mark.time_range.end

    def clip(e):
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        return (e.name, s, t) if t > s else None

    # The marker shows on the device's timeline too, as an annotation.
    ops = [c for e in events if e.device_type == DeviceType.CUDA and e.name != MARK
           if (c := clip(e))]
    host = [c for e in events if e.device_type == DeviceType.CPU and e.name != MARK
            if (c := clip(e))]
    return Trace(ops=ops, host=host, start_us=w0, window_us=w1 - w0, work=work)
