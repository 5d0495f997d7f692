"""B2's share of its roofline in the PPO cells: the least time of the
traced stretch's ``onehot_linear_kernel`` launches (the rollout's first
layer, one a step over every agent of every env), each at
:func:`portbench.counting.onehot_linear_bound_s`, over their device
time, in %. None where the stretch launched none."""

import re

from portbench import counting


def read(ctx):
    ops = ctx.trace.named(lambda n: re.search(r'onehot_linear_kernel', n))
    if not ops:
        return None
    s = ctx.shapes
    device_s = sum(end - start for _, start, end in ops) / 1e6
    bound = counting.onehot_linear_bound_s(s['envs'] * s['agents'], s['net'])
    return 100 * len(ops) * bound / device_s
