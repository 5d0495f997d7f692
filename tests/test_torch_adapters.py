"""The port's host-side adapters ≡ the JAX package's (multigrid_tpu/adapters):
Gymnasium, PettingZoo, the RLlib protocol, the MiniGrid facade.

The dicts of ``GymAdapter.reset``/``step`` equal the JAX adapter's from the
same seed (the same keys give the same layouts and agent orders), partial
action dicts and wrapped envs included; then the JAX package's adapter
tests, on the port.
"""

import inspect
import os
import subprocess
import sys

import gymnasium
import jax
import numpy as np
import pytest
import torch

from multigrid_tpu import wrappers as jax_wrappers
from multigrid_tpu.adapters import GymAdapter as JaxGymAdapter
from multigrid_tpu.envs import make as jax_make
from multigrid_tpu_torch import wrappers
from multigrid_tpu_torch.adapters import (
    GymAdapter,
    PettingZooWrapper,
    RLlibWrapper,
    register_gymnasium_envs,
    to_pettingzoo_env,
    to_rllib_env,
)
from multigrid_tpu_torch.core.mission import Mission
from multigrid_tpu_torch.core.state import FIELDS
from multigrid_tpu_torch.envs import CONFIGURATIONS, make
from multigrid_tpu_torch.envs.empty import EmptyEnv
from multigrid_tpu_torch.render import render_state
from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMPTY = 'MultiGrid-Empty-8x8-v0'
BUP = 'MultiGrid-BlockedUnlockPickup-v0'
#: Action dicts: whole, partial (agent 1 or 0 alone) and empty.
SCRIPT = [{0: 2, 1: 1}, {0: 0}, {1: 2}, {0: 2, 1: 2}, {}, {0: 1, 1: 3}, {1: 5}, {0: 4, 1: 2}]


def _pair(env_id, wrapper):
    jenv, env = jax_make(env_id, agents=2), make(env_id, agents=2, device='cpu')
    if wrapper is not None:
        jenv, env = getattr(jax_wrappers, wrapper)(jenv), getattr(wrappers, wrapper)(env)
    return JaxGymAdapter(jenv), GymAdapter(env)


def _assert_dicts_equal(ours, theirs, where):
    assert set(ours) == set(theirs), where
    for i in theirs:
        a, b = ours[i], theirs[i]
        if isinstance(b, dict) and b:  # an agent's observation
            assert set(a) == set(b), where
            np.testing.assert_array_equal(a['image'], b['image'], err_msg=where)
            assert a['image'].dtype == b['image'].dtype, where
            assert a['direction'] == b['direction'], where
            assert str(a['mission']) == str(b['mission']), where
            assert a['mission'].index == b['mission'].index, where
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=where)
            assert a.dtype == b.dtype, where
        else:
            assert type(a) is type(b) and a == b, (where, i, a, b)


@pytest.mark.parametrize('env_id,wrapper', [(EMPTY, None), (BUP, None),
                                            (EMPTY, 'ImgObsWrapper'),
                                            (BUP, 'OneHotObsWrapper')])
def test_gym_adapter_dicts_match_jax(env_id, wrapper):
    """The same seed gives the JAX adapter's episode: its reset key, its
    layout, and each step's agent order drawn from the state's key, so
    every dict and every state field, ``rng`` included, is equal."""
    jad, ad = _pair(env_id, wrapper)
    jobs, jinfo = jad.reset(seed=7)
    obs, info = ad.reset(seed=7)
    _assert_dicts_equal(obs, jobs, 'reset')
    assert info == jinfo
    for t, actions in enumerate(SCRIPT):
        jout = jad.step(actions)
        out = ad.step(actions)
        for k, (ours, theirs) in enumerate(zip(out, jout)):
            _assert_dicts_equal(ours, theirs, f't={t} field {k}')
        want = jax.device_get(jad._state)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(ad._state, k)[0].numpy(), getattr(want, k),
                                          err_msg=f't={t} {k}')
        np.testing.assert_array_equal(ad._state.rng[0].numpy(),
                                      np.asarray(jax.random.key_data(jad._state.rng)))



def test_gym_adapter_api():
    env = GymAdapter(make(EMPTY, agents=2, device='cpu'))
    obs, infos = env.reset(seed=0)
    assert set(obs) == {0, 1} and set(infos) == {0, 1}
    assert obs[0]['image'].shape == (7, 7, 3)
    assert isinstance(obs[0]['mission'], Mission)
    assert env.observation_space[0]['image'].shape == (7, 7, 3)
    assert env.action_space[1].n == 7
    obs, rewards, terms, truncs, infos = env.step({0: 2, 1: 1})
    assert isinstance(rewards[0], float) and isinstance(terms[1], bool)
    before = env._state.agent_dir.clone()
    env.step({0: 0})  # agent 1 is missing: it does not turn
    assert env._state.agent_dir[0, 1] == before[0, 1]
    assert env._state.agent_dir[0, 0] != before[0, 0]
    assert 'W' in str(env)


def test_gym_seeding_determinism():
    env1 = GymAdapter(make('MultiGrid-Empty-Random-5x5-v0', agents=2, device='cpu'))
    env2 = GymAdapter(make('MultiGrid-Empty-Random-5x5-v0', agents=2, device='cpu'))
    o1, _ = env1.reset(seed=42)
    o2, _ = env2.reset(seed=42)
    np.testing.assert_array_equal(o1[0]['image'], o2[0]['image'])
    for _ in range(5):
        s1 = env1.step({0: 2, 1: 1})
        s2 = env2.step({0: 2, 1: 1})
        np.testing.assert_array_equal(s1[0][0]['image'], s2[0][0]['image'])
        assert s1[1] == s2[1]
    firsts = {tuple(env1.reset(seed=s)[0][0]['image'].ravel()) for s in range(8)}
    assert len(firsts) > 1


@pytest.fixture
def gym_registry():
    """Restores the registry entries the test replaces: the JAX package's
    tests register the same ids in the same process."""
    saved = {k: gymnasium.registry.get(k) for k in CONFIGURATIONS}
    yield
    for k, spec in saved.items():
        if spec is None:
            gymnasium.registry.pop(k, None)
        else:
            gymnasium.registry[k] = spec


def test_gym_registration(gym_registry):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # overriding the JAX package's entries
        register_gymnasium_envs()
    env = gymnasium.make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu',
                         disable_env_checker=True)
    assert isinstance(env.unwrapped, GymAdapter)
    obs, infos = env.reset(seed=1)
    assert obs[0]['image'].shape == (7, 7, 3)
    assert set(CONFIGURATIONS) <= set(gymnasium.registry.keys())


def test_pettingzoo_api():
    env = PettingZooWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))
    obs, infos = env.reset(seed=0)
    assert env.agents == ['agent_0', 'agent_1']
    assert env.action_space('agent_0').n == 7
    assert env.observation_space('agent_1')['direction'].n == 4
    obs, rewards, terms, truncs, infos = env.step({'agent_0': 2, 'agent_1': 2})
    assert set(rewards) == {'agent_0', 'agent_1'}
    # Drive agent 0 to the goal: it must drop from the live agents list
    # (pettingzoo/__init__.py:52-57); success mode 'any' ends the episode.
    env.reset(seed=0)
    done_agents = None
    for a in [2, 2, 1, 2, 2]:
        obs, rewards, terms, truncs, infos = env.step({'agent_0': a, 'agent_1': 6})
        if any(terms.values()):
            done_agents = list(env.agents)
            break
    assert done_agents == []
    assert rewards['agent_0'] == pytest.approx(1 - 0.9 * 5 / 100)


def test_pettingzoo_factory():
    cls = to_pettingzoo_env(EmptyEnv, size=5, agents=2, device='cpu')
    obs, infos = cls().reset(seed=0)
    assert len(obs) == 2


def test_pettingzoo_parallel_api_conformance():
    pz = pytest.importorskip('pettingzoo')
    from pettingzoo.test import parallel_api_test
    env = PettingZooWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))
    assert isinstance(env, pz.ParallelEnv)
    parallel_api_test(env, num_cycles=30)


def test_rllib_protocol():
    env = RLlibWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))
    env.reset(seed=0)
    obs, rewards, terms, truncs, infos = env.step({0: 2, 1: 6})
    assert '__all__' in terms and '__all__' in truncs
    assert terms['__all__'] is False
    for a in [2, 1, 2, 2]:
        obs, rewards, terms, truncs, infos = env.step({0: a, 1: 6})
    assert terms['__all__'] is True  # agent 0 reached the goal: 'any' ends all
    cls = to_rllib_env(EmptyEnv, default_config={'size': 5, 'agents': 2, 'device': 'cpu'})
    env2 = cls({'agents': 1})
    assert env2.env.num_agents == 1


def test_rllib_multiagentenv_contract_double():
    """The RLlib ``MultiAgentEnv`` surface the JAX package vendors as a
    contract double (tests/test_adapters.py:212-289), on the port."""
    env = RLlibWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))
    assert env.agents == [0, 1] and env.possible_agents == env.agents
    sig = inspect.signature(env.reset)
    assert all(sig.parameters[p].kind is inspect.Parameter.KEYWORD_ONLY
               for p in ('seed', 'options'))
    assert len(inspect.signature(env.step).parameters) == 1
    for getter in (env.get_observation_space, env.get_action_space):
        assert len(inspect.signature(getter).parameters) == 1
    obs, infos = env.reset(seed=0)
    for aid in obs:
        assert env.get_observation_space(aid).contains(obs[aid])
    actions = {aid: env.get_action_space(aid).sample() for aid in env.agents}
    obs, rewards, terminateds, truncateds, infos = env.step(actions)
    assert isinstance(terminateds['__all__'], bool)
    assert set(rewards) <= set(env.possible_agents)
    for aid in obs:
        assert env.get_observation_space(aid).contains(obs[aid])
    cls = to_rllib_env(EmptyEnv, default_config={'size': 5, 'agents': 2, 'device': 'cpu'})
    assert len(inspect.signature(cls.__init__).parameters) == 2
    assert set(cls(None).reset(seed=1)[0]) == {0, 1}


def test_minigrid_interface():
    env = MiniGridInterface(make('MultiGrid-Empty-5x5-v0', device='cpu'))
    obs, info = env.reset(seed=0)
    assert obs['image'].shape == (7, 7, 3)
    assert tuple(env.agent_pos) == (1, 1) and env.agent_dir == 0
    assert env.carrying is None
    obs, reward, term, trunc, info = env.step(2)
    assert isinstance(reward, float) and not term
    assert env.steps_remaining == env.env.cfg.max_steps - 1
    with pytest.raises(AssertionError):
        MiniGridInterface(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))


@pytest.mark.parametrize('wrapper', [None, 'OneHotObsWrapper', 'FullyObsWrapper',
                                     'ImgObsWrapper'])
def test_adapter_spaces_match_jax(wrapper):
    """The joint spaces equal the JAX adapter's (dtypes included; the
    mission spaces by their size), and hold what reset returns."""
    jad, ad = _pair(EMPTY, wrapper)
    assert ad.action_space == jad.action_space
    ours, theirs = ad.observation_space, jad.observation_space
    assert set(ours.spaces) == set(theirs.spaces) == {0, 1}
    for i in (0, 1):
        a, b = ours[i], theirs[i]
        if isinstance(b, gymnasium.spaces.Dict):
            assert set(a.spaces) == set(b.spaces)
            for k in b.spaces:
                if k == 'mission':
                    assert len(a[k].mission_space) == len(b[k].mission_space)
                else:
                    assert a[k] == b[k] and a[k].dtype == b[k].dtype, k
        else:
            assert a == b and a.dtype == b.dtype
    obs, _ = ad.reset(seed=0)
    for i in (0, 1):
        assert ours[i].contains(obs[i])


def test_rgb_array_render_is_the_frame():
    env = GymAdapter(make(BUP, agents=2, device='cpu'), render_mode='rgb_array')
    env.reset(seed=3)
    env.step({0: 2, 1: 0})
    np.testing.assert_array_equal(env.render(), render_state(env.env, env._state))
    assert env.get_frame(highlight=False, tile_size=8).shape == (6 * 8, 11 * 8, 3)


def test_adapters_run_without_gymnasium():
    """Where gymnasium and pettingzoo are absent (as on a machine with only
    the port's requirements), the adapters import, reset and step; the
    spaces raise ImportError."""
    code = (
        f"import sys\nsys.path.insert(0, {ROOT!r})\n"
        "for m in ('gymnasium', 'pettingzoo', 'ray', 'jax', 'multigrid_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from multigrid_tpu_torch import make\n"
        "from multigrid_tpu_torch.adapters import GymAdapter, PettingZooWrapper, RLlibWrapper\n"
        "from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface\n"
        "env = GymAdapter(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device='cpu'))\n"
        "obs, _ = env.reset(seed=0)\n"
        "obs, rew, term, trunc, _ = env.step({0: 2})\n"
        "assert obs[1]['image'].shape == (7, 7, 3) and set(rew) == {0, 1}\n"
        "pz = PettingZooWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))\n"
        "pz.reset(seed=0)\n"
        "assert set(pz.step({'agent_0': 2, 'agent_1': 1})[1]) == {'agent_0', 'agent_1'}\n"
        "rl = RLlibWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'))\n"
        "rl.reset(seed=0)\n"
        "assert '__all__' in rl.step({0: 2, 1: 1})[2]\n"
        "mg = MiniGridInterface(make('MultiGrid-Empty-5x5-v0', device='cpu'))\n"
        "mg.reset(seed=0)\n"
        "assert mg.step(2)[0]['image'].shape == (7, 7, 3)\n"
        "try:\n"
        "    env.observation_space\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, '-I', '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
