"""The observations' device microseconds an env step, by the program's
stage counters inside its graphs (:mod:`portbench.stages`): ``observe``,
the obs kernel (B1), the mission and the observation wrappers."""

from portbench import stages


def read(ctx):
    return stages.us_per_step(stages.of(ctx), 'observe')
