"""The rollout loop's own device microseconds an env step, by the
program's stage counters inside its graphs (:mod:`portbench.stages`): the
rollout's sums (``summary``) and the graph's copy of its carried state
into its inputs (``carry``)."""

from portbench import stages


def read(ctx):
    return stages.us_per_step(stages.of(ctx), 'summary', 'carry')
