"""Device operations (kernels, copies and sets) a random-rollout env step
in the traced stretch, from the profiler's trace."""


def read(ctx):
    return len(ctx.trace.ops) / ctx.trace.work if ctx.trace.ops else None
