"""The keyed draws' device microseconds an env step, by the program's
stage counters inside its graphs (:mod:`portbench.stages`): the random
actions' draw (R1, ``draws.actions``) and each step's draws (R2,
``draws.step``), with the time the device waited for them."""

from portbench import stages


def read(ctx):
    return stages.us_per_step(stages.of(ctx), 'draws.actions', 'draws.step')
