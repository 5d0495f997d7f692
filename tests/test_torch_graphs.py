"""The port's graphed paths can be captured, shown on the CPU.

On the card ``VectorEnv.rollout_random``, ``VectorEnv.step``,
``MultiGridEnv.reset``/``step`` and the PPO update replay CUDA graphs
(``multigrid_tpu_torch/utils/graphs.py``). A graph captured once serves
every later call only if each call issues the same operations with the same
non-tensor arguments, reads nothing from the device on the host and copies
no host data to the device. A ``TorchDispatchMode`` records the aten
operations of two consecutive calls of each captured function here, after
one warm-up call as the capture has, with the kernels' plain versions
recorded as one opaque launch each (on the card they are one kernel;
``tests/torch_capture.py``), and these tests hold the two records equal
and free of host reads.

The device-tensor forms that make this possible are held to the JAX
package: the reserve pool's gather and refresh slots over a full period
(multigrid_tpu/parallel/vector.py:293-327, 392-405) and Adam with the
learning-rate schedule against optax. A checkpoint that holds the counts
as ints (as checkpoints did before they moved onto the device) still
resumes exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multigrid_tpu_torch.core.state import STATE_FIELDS, ResetPool
from multigrid_tpu_torch.envs import CONFIGURATIONS, make
from multigrid_tpu_torch.learn import PPOConfig, linear_schedule, make_train_step, ppo_init
from multigrid_tpu_torch.learn.ppo import Optimizer
from multigrid_tpu_torch.ops import fused_ppo
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import graphs
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from multigrid_tpu_torch.utils import prng

from . import torch_capture
from .torch_capture import assert_capturable as _assert_capturable
from .torch_capture import chain as _chain

torch.set_num_threads(1)

BUP = 'MultiGrid-BlockedUnlockPickup-v0'


@pytest.fixture
def record():
    """``record(fn)``: the records of two consecutive calls of ``fn`` after
    one warm-up call, with the kernels' plain versions opaque."""
    return torch_capture.record


# ------------------------------------------------------------ the graphed paths

def _random_carry(venv, seed):
    _, state = venv.reset(seed=seed)
    zero = torch.zeros((), dtype=torch.int64)
    return state, prng.key(seed + 1), (torch.zeros(()), zero, zero.clone())


def test_rollout_step_body_is_capturable(record):
    """``rollout_random`` over Empty-8x8 (2 agents, 8 envs, no pool): its
    one-step graph's body."""
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, max_steps=3, device='cpu'), 8)
    assert not venv.reset_pool
    body = _chain(lambda c: venv._random_steps(c, 1, refresh=True), _random_carry(venv, 0))
    _assert_capturable(record(body), 'empty step')


def test_rollout_chunk_body_on_the_pool_is_capturable(record):
    """BUP on the reserve pool (32 envs, two chunks of 16 with their
    refreshes): the chunk graph's body, the pool's gather and refresh
    slots moving on the device from chunk to chunk."""
    venv = VectorEnv(make(BUP, agents=2, max_steps=6, device='cpu'), 32,
                     reset_pool_period=4)
    assert venv.reset_pool
    body = _chain(lambda c: venv._random_steps(c, venv.REFRESH_CHUNK, refresh=False),
                  _random_carry(venv, 1))
    _assert_capturable(record(body), 'bup chunk')


#: Every configuration on the exact reset, the procedural ones also on the
#: reserve pool.
STEP_CASES = [(k, False) for k in sorted(CONFIGURATIONS)] + [
    (k, True) for k in sorted(CONFIGURATIONS) if CONFIGURATIONS[k][0].procedural_reset]


@pytest.mark.parametrize('env_id,pool', STEP_CASES,
                         ids=[f'{k}-{"pool" if p else "exact"}' for k, p in STEP_CASES])
def test_vector_step_of_every_configuration_is_capturable(record, env_id, pool):
    """``VectorEnv.step`` of each of the 13 configurations (2 agents, 8
    envs, episodes of 2 steps so that envs reset), on the exact reset and,
    for the procedural ones, on the reserve pool."""
    env = make(env_id, agents=2, max_steps=2, device='cpu')
    venv = VectorEnv(env, 8, reset_pool=pool, reset_pool_period=4)
    _, state = venv.reset(seed=2)
    gen = torch.Generator().manual_seed(3)

    def step(s):
        actions = torch.randint(0, 7, (8, 2), generator=gen, dtype=torch.int32)
        return venv._step(s, actions)[1]
    _assert_capturable(record(_chain(step, state)), env_id)


@pytest.mark.parametrize('name', ['FullyObsWrapper', 'ImgObsWrapper', 'OneHotObsWrapper'])
def test_wrapped_vector_step_is_capturable(record, name):
    """A wrapped ``VectorEnv.step`` (the wrapper chain runs inside the
    step's graph, after the kernel), BUP on the pool."""
    from multigrid_tpu_torch import wrappers
    venv = VectorEnv(getattr(wrappers, name)(make(BUP, agents=2, max_steps=2, device='cpu')),
                     8, reset_pool_period=4)
    _, state = venv.reset(seed=0)
    actions = torch.zeros((8, 2), dtype=torch.int32)
    _assert_capturable(record(_chain(lambda s: venv._step(s, actions)[1], state)), name)


def test_env_reset_and_step_are_capturable(record):
    """``MultiGridEnv.reset`` and ``step`` (the single-call graphs that the
    adapters replay), on BUP with an action mask."""
    env = make(BUP, agents=2, device='cpu')
    keys = env.keys(0)
    _assert_capturable(record(lambda: env._reset(keys)), 'reset')
    _, state = env.reset(keys)
    mask = torch.tensor([[True, False]])
    actions = torch.tensor([[2, 0]], dtype=torch.int32)
    body = _chain(lambda s: env._step(s, actions, mask)[1], state)
    _assert_capturable(record(body), 'step')


VARIANTS = {
    'default': dict(),
    'gate-off': dict(gate=False),
    'fused-policy': dict(fused=True),
    'per-agent': dict(config=dict(per_agent_policies=True)),
    'per-agent-gate-off': dict(config=dict(per_agent_policies=True), gate=False),
    'critic': dict(config=dict(centralized_critic=True)),
    'cnn': dict(encoder='cnn', packed=False),
    'bup-pool': dict(env_id=BUP),
}


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_train_update_is_capturable(record, monkeypatch, variant):
    """The PPO update, ``TrainStep.update`` (the update graph's body): mlp
    32, T 4, 2 epochs x 2 minibatches, ``--lr-anneal``'s schedule on, in
    each learner variant."""
    v = VARIANTS[variant]
    if not v.get('gate', True):
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    if v.get('fused'):
        monkeypatch.setenv('MULTIGRID_FUSED_POLICY', '1')
    venv = VectorEnv(make(v.get('env_id', 'MultiGrid-Empty-8x8-v0'), agents=2, max_steps=3,
                          device='cpu'), 8, packed_obs=v.get('packed', True))
    config = PPOConfig(rollout_steps=4, epochs=2, minibatches=2, **v.get('config', {}))
    state, net, config, tx = ppo_init(
        venv, 0, config=config, hidden=32, dtype=torch.float32,
        net_kwargs=dict(encoder=v.get('encoder', 'mlp')),
        lr_schedule=linear_schedule(3e-4, 0.0, 8))
    step = make_train_step(venv, net, config, tx)
    assert step.fused_policy == bool(v.get('fused'))
    body = _chain(lambda s: step.update(s)[0], state)
    _assert_capturable(record(body), variant)


# --------------------------------------------------------- the graph helpers

def test_trees_flatten_load_and_clone():
    """States with extras and a pool, optimizer states and ``None`` leaves
    round-trip through ``flatten``/``unflatten``; ``load`` copies into
    buffers; ``clone`` shares no tensor; the signature holds the static
    leaves and the tensors' shapes and dtypes."""
    venv = VectorEnv(make(BUP, agents=2, device='cpu'), 4)
    _, state = venv.reset(seed=0)
    opt = Optimizer(linear_schedule(1.0, 0.0, 4), 1.0).init({'w': torch.zeros(3)})
    tree = (state, opt, None, {'x': torch.ones(2)})
    leaves, spec = graphs.flatten(tree)
    again = graphs.unflatten(spec, leaves)
    assert graphs.flatten(again)[1] == spec
    assert all(a is b for a, b in zip(graphs.flatten(again)[0], leaves))
    copy = graphs.clone(tree)
    assert all(a.data_ptr() != b.data_ptr() or not a.numel()
               for a, b in zip(graphs.flatten(copy)[0], leaves))
    assert graphs.signature(copy) == graphs.signature(tree)
    _, other = venv.reset(seed=1)
    buffers = graphs.clone(tree)
    graphs.load(buffers, (other, opt, None, {'x': torch.zeros(2)}))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(buffers[0], f), getattr(other, f)), f
    assert torch.equal(buffers[0].pool.reserve.grid, other.pool.reserve.grid)
    assert not buffers[3]['x'].any()
    assert graphs.signature((state, None)) != graphs.signature((state, torch.ones(1)))
    with pytest.raises(ValueError):
        graphs.load(buffers, (other, opt, torch.ones(1), {'x': torch.zeros(2)}))


def test_graphs_are_on_for_the_card_only_and_disable_graphs_turns_them_off():
    """Graphs replay on a CUDA device by default; ``disable_graphs()`` runs
    the eager loop there (nested, and restored after); the CPU runs
    eagerly."""
    cuda = torch.device('cuda')
    assert graphs.graphs_on(cuda) and not graphs.graphs_on('cpu')
    with graphs.disable_graphs():
        assert not graphs.graphs_on(cuda)
        with graphs.disable_graphs():
            assert not graphs.graphs_on(cuda)
        assert not graphs.graphs_on(cuda)
    assert graphs.graphs_on(cuda)
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', device='cpu'), 2)
    assert not venv.graphed()


def test_host_generated_envs_stay_eager():
    """An env whose layouts are built on the host (the MiniGrid builder)
    says so, and a VectorEnv over it would not capture its resets."""
    from multigrid_tpu_torch.utils.minigrid_builder import MiniGridCompatEnv
    assert MiniGridCompatEnv.host_reset
    assert not make('MultiGrid-Empty-5x5-v0', device='cpu').host_reset


# ------------------------------------------- device forms against the JAX package

@pytest.mark.parametrize('e,period,chunk', [(6, 4, 1), (6, 4, 2), (8, 2, 16), (5, 128, 1)])
def test_pool_slots_on_the_device_match_jax_over_a_period(e, period, chunk):
    """At every global step of a full period (and past it), the port's
    device-computed gather (``consume``) takes the slots of JAX's
    ``jnp.roll(reserve, -(g mod E))`` (vector.py:392-405) and its refresh
    rewrites the slots of JAX's ``dynamic_update_slice`` at its own start,
    the tail clamped (vector.py:293-327)."""
    venv = VectorEnv(make(BUP, agents=2, device='cpu'), e, reset_pool_period=period)
    _, state = venv.reset(seed=0)
    reserve = state.pool.reserve
    # Slot i's packed grid holds i in every cell (the state lane of the
    # unpacked cell), so a gathered row names its slot; a grid of -1
    # everywhere shows which slots a refresh rewrote.
    ids = torch.arange(e, dtype=torch.int32)
    tagged = reserve.replace(grid=ids.view(e, 1).expand_as(reserve.grid).clone())
    blank = reserve.replace(grid=torch.full_like(reserve.grid, -1))
    for g in range(2 * e * chunk):
        got = venv.consume(ResetPool(tagged, torch.tensor(g))).grid[:, 0, 0, 2].tolist()
        want = np.asarray(jnp.roll(jnp.arange(e), -(g % e))).tolist()
        assert got == want, (g, got, want)
        new = venv._refresh(ResetPool(blank, torch.tensor(g), state.pool.keys),
                            chunk).reserve.grid
        changed = (new != -1).flatten(1).any(1).numpy()
        c = min(e, max(1, -(-e // period)) * chunk)
        cursor = g if chunk == 1 else g // chunk
        start = (cursor % -(-e // c)) * c
        jax_slots = np.asarray(jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros(e, bool), jnp.ones(c, bool), start, 0))
        np.testing.assert_array_equal(changed, jax_slots, err_msg=f'g={g}')


def test_adam_with_the_schedule_on_the_device_matches_optax():
    """Adam's int32 count, its schedule count and the scheduled rate live in
    device tensors; six clipped steps match optax's updates, its counts
    and its schedule's values."""
    rng = np.random.default_rng(1)
    shapes = {'a': (4, 3), 'b': (3,)}
    lr, total = 1e-2, 4
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(optax.linear_schedule(lr, 0.0, total)))
    opt_j = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
    sched = linear_schedule(lr, 0.0, total)
    ours = Optimizer(sched, 0.5)
    opt = ours.init({k: torch.zeros(s) for k, s in shapes.items()})
    assert opt.count.dtype == torch.int32 and opt.count.dim() == 0
    for i in range(6):
        assert float(sched(opt.schedule_count)) == float(
            optax.linear_schedule(lr, 0.0, total)(jnp.int32(i)))
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        want, opt_j = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_j)
        got, opt = ours.update({k: torch.as_tensor(v) for k, v in g.items()}, opt)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=f'step {i} {k}')
        assert int(opt.count) == int(opt_j[1][0].count) == i + 1
        assert int(opt.schedule_count) == int(opt_j[1][1].count) == i + 1


def test_checkpoint_with_int_counts_resumes_exactly(tmp_path):
    """A checkpoint whose optimizer counts and pool step are ints (as
    written before they moved onto the device) restores them as device
    tensors, and training resumes exactly as from the one written now."""
    def setup(seed=0):
        venv = VectorEnv(make(BUP, agents=2, max_steps=5, device='cpu'), 4, packed_obs=True)
        state, net, config, tx = ppo_init(
            venv, seed, config=PPOConfig(rollout_steps=4, epochs=2, minibatches=2),
            net_kwargs=dict(hidden=16, encoder='mlp'),
            lr_schedule=linear_schedule(3e-4, 0.0, 6))
        return venv, state, make_train_step(venv, net, config, tx)

    venv, state, step = setup()
    state, _ = step(state)
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    raw = torch.load(path, weights_only=True)
    ts = raw['train_state']
    ts['opt_state']['count'] = int(ts['opt_state']['count'])
    ts['opt_state']['schedule_count'] = int(ts['opt_state']['schedule_count'])
    ts['env_state']['pool']['step'] = int(ts['env_state']['pool']['step'])
    old = str(tmp_path / 'old')
    torch.save(raw, old)
    results = []
    for p in (path, old):
        venv2, fresh, step2 = setup(seed=7)
        resumed = restore_checkpoint(p, fresh, venv2)
        assert resumed.opt_state.count.dtype == torch.int32
        assert int(resumed.opt_state.count) == 4 and int(resumed.env_state.pool.step) == 4
        for _ in range(2):
            resumed, _ = step2(resumed)
        results.append(resumed)
    a, b = results
    assert torch.equal(a.key, b.key)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert int(a.opt_state.count) == int(b.opt_state.count) == 12
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f)), f
    assert os.path.exists(old)
