"""The frozen plain reference against the port's CPU path, from one seed."""

import pytest
import torch

from portbench import envcheck
from portbench.reference.envs import make as reference_make
from portbench.reference.vector import PlainVectorEnv

CASES = [('MultiGrid-Empty-16x16-v0', 4, False), ('MultiGrid-BlockedUnlockPickup-v0', 2, True)]


@pytest.mark.parametrize('env_id,agents,pool', CASES)
def test_reference_matches_port(env_id, agents, pool):
    from multigrid_tpu_torch import VectorEnv, make
    program = VectorEnv(make(env_id, agents=agents, max_steps=20, device='cpu'), 8,
                        packed_obs=True, reset_pool=pool)
    reference = PlainVectorEnv(reference_make(env_id, agents=agents, max_steps=20,
                                              device='cpu'), 8, packed_obs=True, reset_pool=pool)
    reset_key, call_keys = envcheck.keys_of(2**31 + 12345, 3)
    p_obs, p_state = program.reset(reset_key)
    r_obs, r_state = reference.reset(reset_key)
    assert torch.equal(p_obs['image'], r_obs['image'])
    assert envcheck.envs_differ(envcheck.as_reference(p_state), r_state) == 0
    for key in call_keys:
        p_state, p_sum = program.rollout_random(p_state, key, 24)
        r_state, r_sum = reference.rollout_random(r_state, key, 24)
        assert envcheck.envs_differ(envcheck.as_reference(p_state), r_state) == 0
        assert envcheck.pool_differs(envcheck.as_reference(p_state), r_state) == 0
        assert {k: float(v) for k, v in p_sum.items()} == {k: float(v) for k, v in r_sum.items()}
    assert int(p_sum['episodes']) > 0


def test_states_differ_by_env():
    reference = PlainVectorEnv(reference_make('MultiGrid-Empty-16x16-v0', agents=4,
                                              device='cpu'), 8, packed_obs=True)
    _, a = reference.reset(envcheck.keys_of(7, 1)[0])
    b = envcheck.as_reference(a)
    b.agent_dir[3, 1] += 1
    b.grid[5, 2, 2, 0] = 2
    assert envcheck.envs_differ(a, b) == 2
