"""B4's share of its roofline in the PPO cells: the least time of the
traced stretch's PPO-loss calls (``ppo_loss_kernel`` with its partial
sum, and B3's ``onehot_grad_kernel`` with its own on dx1), each call at
:func:`portbench.counting.ppo_loss_bound_s` of one minibatch, over their
device time, in %. None where the stretch ran no ``ppo_loss_kernel``."""

import re

from portbench import counting


def read(ctx):
    ops = ctx.trace.named(lambda n: re.search(r'ppo_loss_kernel|onehot_grad_kernel|'
                                              r'sum_partials_kernel', n))
    calls = sum(1 for name, _, _ in ops if 'ppo_loss_kernel' in name)
    if not calls:
        return None
    s = ctx.shapes
    batch = s['envs'] * s['agents'] * s['rollout_steps'] // s['minibatches']
    device_s = sum(end - start for _, start, end in ops) / 1e6
    return 100 * calls * counting.ppo_loss_bound_s(batch, s['net']) / device_s
