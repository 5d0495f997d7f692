"""The port's step ≡ ``jax.vmap(multigrid_tpu.ops.step.step_with_order)``.

Seeded numpy states (doors, keys, balls, boxes, lava, goals, carried
objects, terminated agents, agents at the borders) go through both with the
same actions, masks and orders for a few chained steps. Every state field,
the rewards (bit for bit), terminations and truncations must be equal.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from multigrid_tpu.core.config import EnvConfig as JaxEnvConfig
from multigrid_tpu.ops.step import step_with_order as jax_step_with_order
from multigrid_tpu_torch.core.config import EnvConfig
from multigrid_tpu_torch.core.state import FIELDS
from multigrid_tpu_torch.ops.step import sample_order, step_with_order
from multigrid_tpu_torch.utils import prng

from .test_torch_states import jax_fields, random_fields, to_jax, to_torch

torch.set_num_threads(1)

E = 32
STEPS = 4

CASES = {
    # name: (width, height, agents, has_boxes, config overrides)
    'overlap-any': (7, 6, 3, True, {}),
    'blocked-joint-all': (7, 6, 3, True, dict(
        allow_agent_overlap=False, joint_reward=True, success_any=False,
        failure_any=True)),
    'twelve-agents-scan': (7, 6, 12, True, dict(allow_agent_overlap=False)),
    'no-boxes-two-agents': (5, 5, 2, False, {}),
    'one-agent': (6, 5, 1, True, dict(joint_reward=True)),
}


@pytest.mark.parametrize('case', list(CASES))
def test_step_matches_jax(case):
    w, h, n, has_boxes, over = CASES[case]
    kw = dict(width=w, height=h, num_agents=n, max_steps=20, **over)
    cfg, jcfg = EnvConfig(**kw), JaxEnvConfig(**kw)
    rng = np.random.default_rng(list(CASES).index(case))
    fields = random_fields(int(rng.integers(1 << 30)), E, w, h, n,
                           has_boxes=has_boxes, max_steps=20)
    ours, theirs = to_torch(fields), to_jax(fields)
    jstep = jax.jit(jax.vmap(functools.partial(jax_step_with_order, jcfg)))
    for t in range(STEPS):
        actions = rng.integers(0, 7, (E, n)).astype(np.int32)
        order = np.argsort(rng.random((E, n)), axis=-1).astype(np.int32)
        mask = rng.random((E, n)) < 0.9
        theirs, j_rew, j_term, j_trunc = jstep(theirs, actions, order, mask)
        ours, rew, term, trunc = step_with_order(
            cfg, ours, torch.as_tensor(actions), torch.as_tensor(order),
            torch.as_tensor(mask))
        want = jax_fields(theirs)
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(ours, k).numpy(), want[k], err_msg=f'{case} t={t} {k}')
        np.testing.assert_array_equal(
            rew.numpy().view(np.int32), np.asarray(j_rew).view(np.int32),
            err_msg=f'{case} t={t} rewards')
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_term))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_trunc))


def test_sample_order_is_a_permutation():
    keys = prng.split(prng.key(0), 64)
    order = sample_order(keys, 5)
    assert torch.equal(order.sort(-1).values, torch.arange(5, dtype=torch.int32).expand(64, 5))
    assert sample_order(keys[:3], 1).tolist() == [[0], [0], [0]]
