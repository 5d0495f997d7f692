"""The device's idle share of the traced stretch in the env cells, in %:
1 - the union of the device operations' intervals over the stretch's
wall time (:meth:`portbench.tracing.Trace.idle_share`)."""


def read(ctx):
    return 100 * ctx.trace.idle_share() if ctx.trace.ops else None
