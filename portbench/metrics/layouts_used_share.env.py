"""The share of the fresh layouts made in the counted stretch that
finished envs took, in %, by the program's counters
(:mod:`portbench.stages`): ``layouts.used`` (each step's finished envs)
over ``layouts.made`` (each exact reset's envs, or each pool refresh's
slots)."""

from portbench import stages


def read(ctx):
    table = stages.of(ctx)
    if table is None or not table['counts'].get('layouts.made'):
        return None
    return 100 * table['counts'].get('layouts.used', 0) / table['counts']['layouts.made']
