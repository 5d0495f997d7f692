"""The auto-reset's device microseconds an env step, by the program's
stage counters inside its graphs (:mod:`portbench.stages`): the fresh
layouts (``reset``: the exact reset, or the pool's gather and unpack), the
merge of fresh and stepped states (``merge``) and the pool's regeneration
(``pool``)."""

from portbench import stages


def read(ctx):
    return stages.us_per_step(stages.of(ctx), 'reset', 'merge', 'pool')
