"""The env dynamics' device microseconds an env step, by the program's
stage counters inside its graphs (:mod:`portbench.stages`): ``dynamics``,
from the step kernel (S1) and the family's hooks to each env's done and
success."""

from portbench import stages


def read(ctx):
    return stages.us_per_step(stages.of(ctx), 'dynamics')
