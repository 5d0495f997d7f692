"""The device's idle microseconds an env step in the traced stretch that
fall inside the host's graph replays (the program's ``mgt.graph.replay``
spans, on the profiler's clock): the idle time the host's launch of each
graph leaves. None where the stretch holds no such span."""

from portbench import tracing


def read(ctx):
    replays = tracing.union(h for h in ctx.trace.host if h[0] == 'mgt.graph.replay')
    if not replays:
        return None
    gaps, total, i, j = ctx.trace.gaps(), 0.0, 0, 0
    while i < len(gaps) and j < len(replays):
        s, e = max(gaps[i][0], replays[j][0]), min(gaps[i][1], replays[j][1])
        total += max(e - s, 0.0)
        if gaps[i][1] < replays[j][1]:
            i += 1
        else:
            j += 1
    return total / ctx.trace.work
