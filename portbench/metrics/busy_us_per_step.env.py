"""The device's busy microseconds an env step in the traced stretch: the
union of the device operations' intervals over the stretch's steps. The
steady part of ``env_agent_steps_per_s``: the window's rate also holds
the host's gaps, which vary from run to run."""


def read(ctx):
    return ctx.trace.busy_us() / ctx.trace.work if ctx.trace.ops else None
