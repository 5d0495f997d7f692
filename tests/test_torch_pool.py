"""The port's reserve pool ≡ the JAX package's (multigrid_tpu/parallel/vector.py).

The JAX package's pool tests (tests/test_vector.py:94-290) ported to the
port's ``VectorEnv``; the slot arithmetic against the JAX formula; the
extras a finished env takes from its reserve slot; and one parity test in
which both packages hold the same reserve (carried across as numpy) and
step under the same actions and orders, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.ops.step import sample_order as jax_sample_order
from multigrid_tpu.parallel import VectorEnv as JaxVectorEnv
from multigrid_tpu.parallel.vector import _GSTEP, _RESERVE
from multigrid_tpu_torch.core.constants import STATE_CLOSED, TYPE_BOX, TYPE_DOOR
from multigrid_tpu_torch.core.state import FIELDS, STATE_FIELDS, ResetPool, state_from_arrays
from multigrid_tpu_torch.envs import CONFIGURATIONS, make
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import prng

torch.set_num_threads(1)

BUP = 'MultiGrid-BlockedUnlockPickup-v0'
RBD = 'MultiGrid-RedBlueDoors-6x6-v0'
IDLE = 6  # the done action: no agent moves


def _idle(e, n=2):
    return torch.full((e, n), IDLE)


def _per_env_equal(a, b):
    return (a == b).flatten(1).all(1)


# ------------------------------------------ the JAX package's pool tests

def test_reset_pool_defaults():
    """Procedural families take the pool with the JAX default period;
    Empty and Empty-Random keep the exact reset; no auto-reset, no pool."""
    for env_id in sorted(CONFIGURATIONS):
        env = make(env_id, agents=2, device='cpu')
        venv = VectorEnv(env, 4)
        assert venv.reset_pool == ('Empty' not in env_id), env_id
        assert venv.reset_pool_period == min(128, env.cfg.max_steps), env_id
    env = make('MultiGrid-Playground-v0', agents=2, device='cpu')
    assert not VectorEnv(env, 4, auto_reset=False).reset_pool
    assert VectorEnv(make('MultiGrid-Empty-8x8-v0', device='cpu'), 4, reset_pool=True).reset_pool
    with pytest.raises(ValueError, match='at least 1'):
        VectorEnv(env, 4, reset_pool_period=0)


def test_reset_pool_auto_reset():
    """Done envs swap in a pregenerated, valid and fresh layout."""
    venv = VectorEnv(make('MultiGrid-Playground-v0', agents=2, max_steps=3, device='cpu'), 4,
                     reset_pool_period=2)
    _, state = venv.reset(seed=0)
    first = state.grid.clone()
    for _ in range(3):
        _, state, _, _, _, done, _ = venv.step(state, torch.zeros((4, 2), dtype=torch.int32))
    assert done.all() and (state.step_count == 0).all()
    assert (state.grid[..., 0] == TYPE_DOOR).flatten(1).any(1).all()
    assert (state.agent_pos >= 0).all()
    assert not _per_env_equal(state.grid, first).any()


def test_reset_pool_determinism_and_refresh():
    """Same seed and actions, the same trajectories; consecutive episodes
    get different layouts."""
    env = make(BUP, agents=2, max_steps=4, device='cpu')
    grids = []
    for _ in range(2):
        venv = VectorEnv(env, 4, reset_pool_period=2)
        _, state = venv.reset(seed=7)
        seen = []
        for _ in range(12):
            _, state, *_, done, _ = venv.step(state, _idle(4))
            if done.all():
                seen.append(state.grid.clone())
        grids.append(seen)
    assert len(grids[0]) == 3
    for a, b in zip(*grids):
        assert torch.equal(a, b)
    assert not torch.equal(grids[0][0], grids[0][1])
    assert not torch.equal(grids[0][1], grids[0][2])


def _no_replay(layouts):
    for a, b in zip(layouts, layouts[1:]):
        same = _per_env_equal(a, b)
        assert not same.any(), f'layout replay in envs {same.nonzero().flatten().tolist()}'


def test_reset_pool_no_replay_for_short_episodes():
    """Episodes far shorter than the period still get a fresh layout each
    reset: consecutive episode ends of one env read different slots."""
    venv = VectorEnv(make(BUP, agents=2, max_steps=10, device='cpu'), 8,
                     reset_pool_period=128)
    assert venv.reset_pool and venv.reset_pool_period == 128
    _, state = venv.reset(seed=3)
    layouts = [state.grid.clone()]
    for _ in range(30):
        _, state, *_, done, _ = venv.step(state, _idle(8))
        if done.all():
            layouts.append(state.grid.clone())
    assert len(layouts) == 4
    _no_replay(layouts)


def test_reset_pool_rotation_determinism():
    env = make(RBD, agents=2, max_steps=5, device='cpu')
    seqs = []
    for _ in range(2):
        venv = VectorEnv(env, 8, reset_pool=True, reset_pool_period=64)
        _, state = venv.reset(seed=11)
        seen = []
        for _ in range(15):
            _, state, *_, done, _ = venv.step(state, _idle(8))
            if done.all():
                seen.append(state.grid.clone())
        seqs.append(seen)
    assert len(seqs[0]) == 3
    for a, b in zip(*seqs):
        assert torch.equal(a, b)


def test_reset_pool_chunked_refresh_no_replay():
    """K steps with ``refresh=False`` and one ``refresh_pool(K)`` keep the
    contract: the step still advances, no env replays its layout."""
    venv = VectorEnv(make(BUP, agents=2, max_steps=10, device='cpu'), 8,
                     reset_pool_period=128)
    _, state = venv.reset(seed=3)
    layouts = [state.grid.clone()]
    k = 10
    for _ in range(3):
        for _ in range(k):
            _, state, *_, done, _ = venv.step(state, _idle(8), refresh=False)
        state = venv.refresh_pool(state, k)
        assert done.all()
        layouts.append(state.grid.clone())
    assert state.pool.step == 3 * k
    _no_replay(layouts)


def test_reset_pool_chunked_refresh_regenerates_slots():
    """``refresh_pool(K)`` rewrites K steps' worth of slots: at period 4 on
    8 envs, 2 slots a step, so a chunk of 4 rewrites all 8, and leaves the
    state it was given as it was."""
    venv = VectorEnv(make(RBD, agents=2, device='cpu'), 8, reset_pool_period=4)
    _, state = venv.reset(seed=5)
    before = state.pool.reserve.clone()
    for _ in range(4):
        _, state, *_ = venv.step(state, _idle(8), refresh=False)
    assert torch.equal(state.pool.reserve.grid, before.grid)
    kept = state.pool.reserve.grid.clone()
    after = venv.refresh_pool(state, 4)
    assert not _per_env_equal(after.pool.reserve.grid, before.grid).any()
    assert torch.equal(state.pool.reserve.grid, kept)
    assert after.pool.step == state.pool.step == 4


# ------------------------------------------------------ slot arithmetic

def _jax_slots(e, period, step, chunk):
    """The slots multigrid_tpu/parallel/vector.py:_refresh_pool rewrites,
    by its own formula, the tail clamped by ``dynamic_slice`` itself."""
    c = min(e, max(1, -(-e // period)) * chunk)
    n_slices = -(-e // c)
    cursor = step if chunk == 1 else step // chunk
    start = (cursor % n_slices) * c
    return np.asarray(jax.lax.dynamic_slice_in_dim(jnp.arange(e), start, c, 0)).tolist()


@pytest.mark.parametrize('e', [4, 6, 8])
@pytest.mark.parametrize('period', [1, 2, 4, 128])
def test_refresh_slots_match_the_jax_formula(e, period):
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', device='cpu'), e, reset_pool=True,
                     reset_pool_period=period)
    for chunk in (1, 2, 3, 16):
        for step in range(0, 40):
            start, count = venv.refresh_slots(step, chunk)
            assert list(range(start, start + count)) == _jax_slots(e, period, step, chunk), (
                chunk, step)


def test_refresh_rewrites_only_its_slots():
    """E 6 at period 4 (2 slots a step; a chunk of 2 takes 4 slots, whose
    second slice is clamped to slots 2-5): exactly the slots named by
    ``refresh_slots`` change. A slot's layout is ``fold_in(its key, g)``'s,
    so the steps are chosen to give each refresh another ``g`` than the
    slot's last, and a refresh again at the same ``g`` changes nothing."""
    venv = VectorEnv(make(BUP, agents=2, device='cpu'), 6, reset_pool_period=4)
    _, state = venv.reset(seed=2)
    for step, chunk in [(10, 1), (11, 1), (12, 1), (13, 1), (2, 2), (3, 2), (4, 2)]:
        state = state.replace(pool=ResetPool(state.pool.reserve, step, state.pool.keys))
        new = venv.refresh_pool(state, chunk)
        start, count = venv.refresh_slots(step, chunk)
        changed = ~_per_env_equal(new.pool.reserve.grid, state.pool.reserve.grid)
        want = torch.zeros(6, dtype=torch.bool)
        want[start:start + count] = True
        assert torch.equal(changed, want), (step, chunk, changed)
        again = venv.refresh_pool(new, chunk)
        assert _per_env_equal(again.pool.reserve.grid, new.pool.reserve.grid).all()
        state = new
    assert venv.refresh_slots(2, 2) == (2, 4) and venv.refresh_slots(4, 2) == (0, 4)



# ------------------------------------------------- extras from the reserve

@pytest.mark.parametrize('env_id', [BUP, RBD])
def test_done_env_takes_its_reserve_slots_extras(env_id):
    """Every env that finishes holds reserve slot ``(i + g) mod E``, read
    just before the step, fields and extras alike; the layout's extras
    agree with its grid (mission = the box's color; red and blue doors at
    ``red_pos``/``blue_pos``)."""
    e = 6
    venv = VectorEnv(make(env_id, agents=2, max_steps=3, device='cpu'), e, reset_pool_period=4)
    _, state = venv.reset(seed=9)
    finished = 0
    for _ in range(9):
        slots = venv.consume(state.pool)
        reserve = venv.pool_unpack(state.pool.reserve)
        assert torch.equal(slots.grid[0], reserve.grid[state.pool.step % e])
        obs, state, *_, done, _ = venv.step(state, _idle(e))
        for i in done.nonzero().flatten().tolist():
            finished += 1
            for f in FIELDS:
                assert torch.equal(getattr(state, f)[i], getattr(slots, f)[i]), f
            for k, v in state.extras.items():
                assert torch.equal(v[i], slots.extras[k][i]), k
    assert finished == 3 * e
    grid, ex = state.grid, state.extras
    if 'mission_color' in ex:
        box = grid[..., 0] == TYPE_BOX
        assert torch.equal(torch.where(box, grid[..., 1], 0).sum((1, 2)), ex['mission_color'])
        assert torch.equal(obs['mission'][:, 0], ex['mission_color'] * 2)
    else:
        env_i = torch.arange(e)
        for key, color in (('red_pos', 0), ('blue_pos', 2)):
            p = ex[key].long()
            cell = grid[env_i, p[:, 0], p[:, 1]]
            assert (cell[:, 0] == TYPE_DOOR).all() and (cell[:, 1] == color).all()
            assert (cell[:, 2] == STATE_CLOSED).all()


def test_rollout_random_refreshes_in_chunks():
    """40 random steps with the pool: two chunks of 16 with one refresh
    each, then 8 steps that refresh every step; the same draws as driving
    the steps by hand."""
    env = make(BUP, agents=2, max_steps=6, device='cpu')
    venv = VectorEnv(env, 4)
    _, state = venv.reset(seed=1)
    end, summary = venv.rollout_random(state, prng.key(2), 40)
    assert end.pool.step == 40 and int(summary['episodes']) > 0
    hand = VectorEnv(env, 4)
    _, s = hand.reset(seed=1)
    key = prng.key(2)
    for t in range(40):
        key, ak = prng.split(key).unbind(0)
        actions = prng.randint(ak, (4, 2), 0, 7)
        _, s, *_ = hand.step(s, actions, refresh=t >= 32)
        if t in (15, 31):
            s = hand.refresh_pool(s, 16)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(end, f)), f
    assert torch.equal(s.pool.reserve.grid, end.pool.reserve.grid)


# ------------------------------------------ bit parity with the JAX pool

def _port_state(jstate, jvenv):
    """The port's state, pool included, from a JAX state with its pool: the
    reserve carried across in the JAX package's packed storage form, which
    is the port's."""
    host = jax.device_get(jstate)
    extras = {k: v for k, v in host.extras.items() if not k.startswith('_vec:')}
    state = state_from_arrays({k: getattr(host, k) for k in FIELDS}, 'cpu', extras=extras)
    reserve = host.extras[_RESERVE]
    reserve = state_from_arrays({k: getattr(reserve, k) for k in FIELDS}, 'cpu',
                                extras=dict(reserve.extras))
    return state.replace(pool=ResetPool(reserve, int(host.extras[_GSTEP][0])))


def _assert_same(ours, theirs, where):
    host = jax.device_get(theirs)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ours, k).numpy(), getattr(host, k),
                                      err_msg=f'{where} {k}')
    for k, v in ours.extras.items():
        np.testing.assert_array_equal(v.numpy(), host.extras[k], err_msg=f'{where} {k}')
    assert ours.pool.step == int(host.extras[_GSTEP][0]), where


def test_consumption_matches_jax_bit_for_bit():
    """BUP, 6 envs, period 4, max_steps 3: both packages hold the same
    reserve and take the same actions and orders with ``refresh=False``;
    the states (fields, extras, the global step) agree bit for bit on
    every step, the three episode ends included. A ``refresh_pool(2)`` on
    the JAX side rewrites exactly the slots the port's ``refresh_slots``
    names (the clamped slice 2-5 at step 6), and its reserve carries on."""
    e, n = 6, 2
    kw = dict(agents=n, max_steps=3, see_through_walls=True)
    jvenv = JaxVectorEnv(jax_make(BUP, **kw), e, reset_pool_period=4)
    venv = VectorEnv(make(BUP, device='cpu', **kw), e, reset_pool_period=4)
    assert jvenv.reset_pool and venv.reset_pool
    _, jstate = jvenv.reset(jax.random.key(4))
    state = _port_state(jstate, jvenv)
    draw_order = jax.jit(jax.vmap(lambda s: jax_sample_order(jax.random.split(s.rng)[0], n)))
    rng = np.random.default_rng(4)
    dones = 0
    for t in range(9):
        if t == 6:
            before = np.asarray(jstate.extras[_RESERVE].grid).reshape(e, -1)
            jstate = jvenv.refresh_pool(jstate, 2)
            after = np.asarray(jstate.extras[_RESERVE].grid).reshape(e, -1)
            start, count = venv.refresh_slots(state.pool.step, 2)
            assert (start, count) == (2, 4)
            assert ((before != after).any(1) == (np.arange(e) >= 2)).all()
            state = _port_state(jstate, jvenv)
        actions = rng.integers(0, 7, (e, n)).astype(np.int32)
        order = np.asarray(draw_order(jstate))
        jout = jvenv.step(jstate, jnp.asarray(actions), refresh=False)
        out = venv.step(state, torch.as_tensor(actions), order=torch.as_tensor(order.copy()),
                        refresh=False)
        jstate, state = jout[1], out[1]
        np.testing.assert_array_equal(out[5].numpy(), np.asarray(jout[5]), err_msg=f't={t}')
        np.testing.assert_array_equal(out[0]['image'].numpy(), np.asarray(jout[0]['image']),
                                      err_msg=f't={t} obs')
        _assert_same(state, jstate, f't={t}')
        dones += int(out[5].sum())
    assert dones == 3 * e


def test_packed_reserve_is_the_jax_packages():
    """The reserve's storage form is the JAX package's ``_pool_pack``
    (vector.py:215-229), bit for bit: the port's reserve drawn from the same
    key equals JAX's stored reserve (one int32 plane a slot, the Boxes'
    contents in bits 12-23, ``box_contents`` zero-sized); ``pool_pack`` of
    JAX's unpacked reserve carried across as numpy equals JAX's
    ``_pool_pack`` of it, run eagerly, and ``pool_unpack`` equals its
    ``_pool_unpack``; the extras and keys stay as they are."""
    e, n = 6, 2
    kw = dict(agents=n, max_steps=3, see_through_walls=True)
    jvenv = JaxVectorEnv(jax_make(BUP, **kw), e, reset_pool_period=4)
    venv = VectorEnv(make(BUP, device='cpu', **kw), e, reset_pool_period=4)
    _, jstate = jvenv.reset(jax.random.key(4))
    _, state = venv.reset(prng.key(4))
    stored = jax.device_get(jstate.extras[_RESERVE])
    assert stored.grid.shape == (e, 11 * 6) and stored.box_contents.shape == (e, 0, 0, 3)
    unpacked = jax.device_get(jvenv._pool_unpack(jstate.extras[_RESERVE], jstate))
    reserve = state.pool.reserve
    for f in ('grid', 'box_contents'):
        np.testing.assert_array_equal(getattr(reserve, f).numpy(), getattr(stored, f), f)
    for k, v in reserve.extras.items():
        np.testing.assert_array_equal(v.numpy(), stored.extras[k], k)
    carried = state_from_arrays({k: getattr(unpacked, k) for k in FIELDS}, 'cpu',
                                extras=dict(unpacked.extras))
    ours = venv.pool_pack(carried)
    theirs = jvenv._pool_pack(jvenv._pool_unpack(jstate.extras[_RESERVE], jstate))
    np.testing.assert_array_equal(ours.grid.numpy(), np.asarray(theirs.grid))
    assert ours.box_contents.shape == theirs.box_contents.shape
    back = venv.pool_unpack(ours)
    for f in ('grid', 'box_contents'):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(unpacked, f), f)
    for f in FIELDS[2:]:
        assert torch.equal(getattr(back, f), getattr(carried, f)), f
    # The box table rides in the upper bits: every cell's is the empty
    # encoding (1, 0, 0), as BUP's Box holds nothing.
    assert ((ours.grid >> 12) == 1 << 8).all()


def test_pool_is_batch_state_carried_whole():
    """``clone`` copies the pool (no tensor shared), ``where_state`` keeps
    ``b``'s pool unmerged, ``state_to_numpy`` carries it, and the per-env
    step never sees it."""
    from multigrid_tpu_torch.core.state import state_to_numpy, where_state
    venv = VectorEnv(make(RBD, agents=2, device='cpu'), 4)
    _, state = venv.reset(seed=6)
    copy = state.clone()
    copy.pool.reserve.grid[0, 0] = 99
    assert state.pool.reserve.grid[0, 0] != 99 and copy.pool.step == state.pool.step
    merged = where_state(torch.tensor([True, False, True, False]), copy, state)
    assert merged.pool is state.pool
    host = state_to_numpy(state)
    assert host['pool']['step'] == 0 and set(host['extras']) == set(state.extras)
    np.testing.assert_array_equal(host['pool']['reserve']['grid'],
                                  state.pool.reserve.grid.numpy())
    assert host['pool']['reserve']['grid'].shape == (4, venv.env.width * venv.env.height)
    seen = []
    step_core = venv.env.step_core
    venv.env.step_core = lambda s, *a, **k: seen.append(s.pool) or step_core(s, *a, **k)
    _, new, *_ = venv.step(state, _idle(4))
    assert seen == [None] and new.pool.step == 1


def test_ppo_rollout_refreshes_the_pool_once():
    """The PPO rollout steps with ``refresh=False`` and refreshes T steps'
    worth of slots once at its end (multigrid_tpu/learn/ppo.py:405,
    439-442); without the pool it refreshes nothing."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    for reset_pool in (None, False):
        venv = VectorEnv(make(BUP, agents=2, device='cpu'), 4, packed_obs=True,
                         reset_pool=reset_pool)
        state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=5),
                                          hidden=16, net_kwargs=dict(encoder='mlp'))
        step = make_train_step(venv, net, config, tx)
        chunks = []
        refresh = venv._refresh
        venv._refresh = lambda pool, chunk: chunks.append(chunk) or refresh(pool, chunk)
        state, *_ = step.rollout_phase(state)
        if reset_pool is None:
            assert chunks == [5] and state.env_state.pool.step == 5
        else:
            assert chunks == [] and state.env_state.pool is None
