"""S1's share of its roofline in the env cells: the least time of the
traced stretch's step-kernel launches (``step_kernel_staged`` or
``step_kernel_global``, one an env step), each at
:func:`portbench.counting.step_bound_s` of the cell's shapes, over their
device time, in %. None where the stretch launched no step kernel."""

import re

from portbench import counting


def read(ctx):
    ops = ctx.trace.named(lambda n: re.search(r'step_kernel_(staged|global)', n))
    if not ops:
        return None
    device_s = sum(end - start for _, start, end in ops) / 1e6
    return 100 * len(ops) * counting.step_bound_s(ctx.shapes) / device_s
