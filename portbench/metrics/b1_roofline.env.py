"""B1's share of its roofline in the env cells: the least time of the
traced stretch's ``obs_kernel`` launches (packed observations of every
agent, one an env step), each at :func:`portbench.counting.obs_bound_s` of
the cell's shapes, over their device time, in %. B1g
(``obs_general_kernel``) is not counted. None where the stretch launched
no ``obs_kernel``."""

import re

from portbench import counting


def read(ctx):
    ops = ctx.trace.named(lambda n: re.search(r'(?<![A-Za-z_])obs_kernel', n))
    if not ops:
        return None
    device_s = sum(end - start for _, start, end in ops) / 1e6
    return 100 * len(ops) * counting.obs_bound_s(ctx.shapes, packed=True) / device_s
