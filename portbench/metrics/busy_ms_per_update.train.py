"""The device's busy milliseconds a PPO update in the traced stretch: the
union of the device operations' intervals over the stretch's updates.
The steady part of ``train_agent_steps_per_s``: the window's rate also
holds the host's gaps."""


def read(ctx):
    return ctx.trace.busy_us() / 1e3 / ctx.trace.work if ctx.trace.ops else None
