"""Tests of the port that need an NVIDIA GPU; they skip without one.

The CUDA kernel has no CPU mode, so these run on the card only; so do the
CUDA graphs, held here to the eager loop (``disable_graphs()``). The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.state import FIELDS, STATE_FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.ops import obs_cuda, step_cuda
from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import prng

from .test_torch_states import random_fields, to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _to(state, device):
    return state.replace(**{k: getattr(state, k).to(device) for k in FIELDS})


@pytest.mark.parametrize('stw', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_kernel_matches_plain(cuda_device, stw, packed):
    """The CUDA kernel ≡ the plain version on the CPU, bit for bit."""
    for w, h, n, vs in [(16, 16, 4, 7), (13, 25, 3, 13), (8, 8, 1, 3),
                        (5, 5, 8, 11)]:
        state = to_torch(random_fields(w + n + vs, 64, w, h, n, has_boxes=False))
        want = gen_obs_batched_plain(state, vs, stw, packed)
        launches = obs_cuda.launches
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
        assert obs_cuda.launches == launches + 1
        assert torch.equal(got.cpu(), want), (w, h, n, vs)


@pytest.mark.parametrize('e,n', [(1, 4), (7, 1), (9, 8), (4097, 4), (1001, 8), (999, 1)])
def test_kernel_matches_plain_at_any_env_count(cuda_device, e, n):
    """Env counts that fill no whole block, one agent and eight, ≡ the
    plain version bit for bit, as images and packed cells."""
    state = to_torch(random_fields(e + n, e, 16, 16, n, has_boxes=False))
    for packed in (False, True):
        want = gen_obs_batched_plain(state, 7, False, packed)
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), 7, False, packed)
        assert torch.equal(got.cpu(), want), (e, n, packed)


@pytest.mark.parametrize('n', [9, 16, 33])
@pytest.mark.parametrize('vs', [7, 15, 31])
def test_kernel_matches_plain_for_any_team_and_view(cuda_device, n, vs):
    """Teams past 8 agents (past 32: a second round of lanes) and views past
    13 (past 15: a fifth doubling step of the fill) ≡ the plain version bit
    for bit, see-through walls on and off, as images and packed cells."""
    state = to_torch(random_fields(100 * n + vs, 64, 16, 16, n, has_boxes=False))
    for stw in (False, True):
        for packed in (False, True):
            want = gen_obs_batched_plain(state, vs, stw, packed)
            launches = obs_cuda.launches
            got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
            assert obs_cuda.launches == launches + 1
            assert torch.equal(got.cpu(), want), (n, vs, stw, packed)


def test_sixteen_agents_step_through_the_kernel(cuda_device):
    """A 16-agent Empty-16x16 VectorEnv on the card resets and steps through
    the obs kernel (one launch a call), its observations equal to the plain
    version on the same states (Empty observes the merged state)."""
    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=16, device=cuda_device), 64)
    launches = obs_cuda.launches
    obs, state = venv.reset(seed=0)
    assert obs['image'].shape == (64, 16, 7, 7, 3)
    assert torch.equal(obs['image'], gen_obs_batched_plain(state, 7, False))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for t in range(24):
        actions = torch.randint(0, 7, (64, 16), generator=g, device=cuda_device)
        obs, state, *_ = venv.step(state, actions)
        assert torch.equal(obs['image'], gen_obs_batched_plain(state, 7, False)), t
    assert obs_cuda.launches == launches + 25


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    """An even view (no config takes one) and a grid of the wrong dtype."""
    state = _to(to_torch(random_fields(0, 4, 8, 8, 2, has_boxes=False)), cuda_device)
    for vs in (8, 32):
        with pytest.raises(ValueError):
            obs_cuda.gen_obs_batched(state, vs, False)
    with pytest.raises(ValueError):
        obs_cuda.gen_obs_batched(state.replace(grid=state.grid.to(torch.int64)), 7, False)


@pytest.mark.parametrize('stw', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_general_kernel_takes_the_other_shapes(cuda_device, stw, packed, monkeypatch):
    """A view column past one 32-bit word (33, 35, 63) and envs whose grid
    and views pass a block's shared memory (64 views of 31 on 32x32, a
    250x250 grid) go to the general kernel, which ≡ the plain version; a
    shape both kernels take gives both the same bits."""
    for w, h, n, vs, e in [(8, 8, 2, 33, 16), (32, 32, 2, 35, 8), (64, 64, 1, 63, 4),
                           (32, 32, 64, 31, 2), (250, 250, 2, 7, 3), (16, 16, 9, 7, 32)]:
        state = to_torch(random_fields(w + n + vs, e, w, h, n, has_boxes=False))
        want = gen_obs_batched_plain(state, vs, stw, packed)
        kernel = obs_cuda.check_supported(n, w, h, vs)
        counts = obs_cuda.launches, obs_cuda.general_launches
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
        assert torch.equal(got.cpu(), want), (w, h, n, vs)
        if kernel == 'general':
            assert (obs_cuda.launches, obs_cuda.general_launches) == (counts[0], counts[1] + 1)
        else:  # the last case: the general kernel, called directly, agrees
            assert (w, h, n, vs) == (16, 16, 9, 7)
            monkeypatch.setattr(obs_cuda, 'check_supported', lambda *a: 'general')
            assert torch.equal(
                obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed), got)


def _overlapping(fields, rng):
    """``fields`` with agents made to share cells: in every env one agent
    moved onto another's cell, and in about a third one agent moved off the
    grid (random_fields already terminates about a fifth)."""
    pos = fields['agent_pos']
    e, n, _ = pos.shape
    w, h = fields['grid'].shape[1:3]
    for env in range(e if n > 1 else 0):
        a, b = rng.choice(n, 2, replace=False)
        pos[env, a] = pos[env, b]
        if rng.random() < 0.3:
            pos[env, rng.integers(n)] = (rng.choice([-1, w]), rng.integers(h))
    return fields


@pytest.mark.parametrize('stw', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_general_kernel_matches_plain_at_the_smoke_shapes(cuda_device, stw, packed):
    """The general kernel ≡ the plain version on chip_smoke.py's general
    shapes (views 33, 35, 63, 65, 101, 165; 250x250; 64 agents of view
    31)."""
    from chip_smoke import GENERAL_SHAPES
    for w, h, n, vs, e in GENERAL_SHAPES:
        state = _to(to_torch(random_fields(w + n + vs, e, w, h, n, has_boxes=False)),
                    cuda_device)
        assert obs_cuda.check_supported(n, w, h, vs) == 'general'
        launches = obs_cuda.general_launches
        got = obs_cuda.gen_obs_batched(state, vs, stw, packed)
        assert obs_cuda.general_launches == launches + 1
        assert torch.equal(got, gen_obs_batched_plain(state, vs, stw, packed)), (w, h, n, vs)


@pytest.mark.parametrize('n', [1, 2, 9, 33, 64])
def test_general_kernel_seeded_sweep(cuda_device, n):
    """Seeded shapes for each team size: odd views 33..63 (a column of one
    64-bit word), then 65, 101 and 165 (columns of 3, 4 and 6 words; 165
    stages its window in strips), grids from 5x5 to 250x250, agents sharing
    cells, terminated and off the grid, every direction, images and packed,
    see-through-walls off and on: the general kernel ≡ the plain version."""
    rng = np.random.default_rng(n)
    views = [int(rng.choice(np.arange(33, 65, 2))) for _ in range(4)] + [65, 101, 165]
    for case, vs in enumerate(views):
        w, h = (250, 250) if case == 0 else rng.integers(5, 80, 2)
        e = int(rng.integers(1, 9)) if vs < 64 else 4
        fields = _overlapping(random_fields(int(rng.integers(1 << 30)), e, int(w), int(h), n,
                                            has_boxes=False), rng)
        fields['agent_dir'][:] = (np.arange(e * n).reshape(e, n) + rng.integers(4)) % 4
        state = _to(to_torch(fields), cuda_device)
        for stw in (False, True):
            for packed in (False, True):
                got = obs_cuda.gen_obs_batched(state, vs, stw, packed)
                want = gen_obs_batched_plain(state, vs, stw, packed)
                assert torch.equal(got, want), (n, vs, w, h, e, stw, packed)


def test_general_kernel_refuses_a_column_past_a_block(cuda_device):
    """Past 92,975 cells one column of the staged window passes a block's
    shared memory: the launcher refuses the view, nothing is launched."""
    vs = 92977
    assert obs_cuda.check_supported(1, 8, 8, vs) == 'general'
    state = _to(to_torch(random_fields(3, 1, 8, 8, 1, has_boxes=False)), cuda_device)
    launches = obs_cuda.general_launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        obs_cuda.gen_obs_batched(state, vs, False, packed=True)
    assert obs_cuda.general_launches == launches
    torch.cuda.empty_cache()


@pytest.mark.parametrize('w,h,n,vs,e', [(16, 16, 4, 7, 4096), (13, 25, 3, 13, 64),
                                        (8, 8, 1, 3, 64), (32, 32, 33, 31, 8),
                                        (19, 19, 10, 7, 256)])
def test_general_kernel_equals_obs_kernel_where_both_take(cuda_device, w, h, n, vs, e,
                                                          monkeypatch):
    """On shapes obs_kernel takes, the general kernel, forced, gives the
    same bits, with agents sharing cells."""
    assert obs_cuda.check_supported(n, w, h, vs) == 'obs'
    fields = _overlapping(random_fields(w * h + n, e, w, h, n, has_boxes=False),
                          np.random.default_rng(vs))
    state = _to(to_torch(fields), cuda_device)
    cases = [(stw, packed) for stw in (False, True) for packed in (False, True)]
    want = [obs_cuda.gen_obs_batched(state, vs, *c) for c in cases]
    monkeypatch.setattr(obs_cuda, 'check_supported', lambda *a: 'general')
    launches = obs_cuda.general_launches
    got = [obs_cuda.gen_obs_batched(state, vs, *c) for c in cases]
    assert obs_cuda.general_launches == launches + len(cases)
    for c, a, b in zip(cases, got, want):
        assert torch.equal(a, b), c


def test_vector_env_on_the_card_matches_the_cpu(cuda_device):
    """The same actions and orders give the same trajectory on the card
    (kernel) as on the CPU (plain version), auto-resets included."""
    envs = [VectorEnv(make('MultiGrid-Empty-6x6-v0', agents=3, max_steps=12,
                           device=d), 32) for d in ('cpu', cuda_device)]
    states = [venv.reset(seed=0)[1] for venv in envs]
    rng = np.random.default_rng(0)
    episodes = 0
    for t in range(30):
        actions = torch.as_tensor(rng.integers(0, 7, (32, 3)))
        order = torch.as_tensor(np.argsort(rng.random((32, 3)), -1))
        outs = [venv.step(st, actions.to(venv.device), order=order.to(venv.device))
                for venv, st in zip(envs, states)]
        (c_obs, *c_rest), (g_obs, *g_rest) = outs
        assert torch.equal(c_obs['image'], g_obs['image'].cpu()), t
        for k in FIELDS:
            assert torch.equal(getattr(c_rest[0], k), getattr(g_rest[0], k).cpu()), (t, k)
        for a, b in zip(c_rest[1:], g_rest[1:]):
            assert torch.equal(a, b.cpu()), t
        states = [c_rest[0], g_rest[0]]
        episodes += int(c_rest[4].sum())
    assert episodes >= 32  # every env truncated at least once


# ----------------------------------------------------- the step kernel

#: The step kernel's cases (W, H, N, boxes, config overrides, E): the CPU
#: tests' grid of flags and teams, 16 and 64 agents, BUP's shape (792-byte
#: grid rows, no multiple of 16), 16,384 envs (several chunks a warp in the
#: staged kernel; also at an env count its chunks do not divide), and the
#: global kernel's shapes (two least stages past a block: a 250x250 grid,
#: 64x64 with a box table and without).
STEP_CASES = {
    'overlap-any': (7, 6, 3, True, {}, 256),
    'blocked-joint-all': (7, 6, 3, True, dict(allow_agent_overlap=False, joint_reward=True,
                                              success_any=False, failure_any=True), 256),
    'twelve-agents-scan': (7, 6, 12, True, dict(allow_agent_overlap=False), 256),
    'no-boxes-two-agents': (5, 5, 2, False, {}, 256),
    'one-agent': (6, 5, 1, True, dict(joint_reward=True), 256),
    'sixteen-agents': (9, 7, 16, True, dict(allow_agent_overlap=False, joint_reward=True), 512),
    'sixty-four-agents': (32, 32, 64, True, dict(success_any=False, failure_any=True), 64),
    'grid-250x250': (250, 250, 4, True, dict(allow_agent_overlap=False), 8),
    'flagship-shape': (16, 16, 4, False, {}, 4096),
    'odd-env-count': (11, 6, 2, True, {}, 4097),
    'bup-shape': (11, 6, 2, True, {}, 4096),
    'flagship-16384': (16, 16, 4, False, {}, 16384),
    'flagship-16387': (16, 16, 4, False, {}, 16387),
    'global-64x64-boxes': (64, 64, 4, True, dict(allow_agent_overlap=False), 64),
    'global-64x64': (64, 64, 4, False, {}, 64),
}
#: The cases the global kernel takes; the staged one takes the rest.
STEP_GLOBAL = ('grid-250x250', 'global-64x64-boxes', 'global-64x64')


def _step_pair(cfg, state, rng, device, mask=True):
    """The kernel on the card and the plain version on the CPU from the
    same state, actions (some outside 0-6), orders and mask."""
    from multigrid_tpu_torch.ops.step import handle_actions, handle_actions_plain
    e, n = state.agent_dir.shape
    state = state.replace(step_count=state.step_count + 1)
    actions = rng.integers(0, 7, (e, n))
    actions = np.where(rng.random((e, n)) < 0.05, rng.choice([-3, 7, 100], (e, n)), actions)
    actions = torch.as_tensor(actions.astype(np.int32))
    order = torch.as_tensor(np.argsort(rng.random((e, n)), -1))
    m = torch.as_tensor(rng.random((e, n)) < 0.9) if mask else None
    want = handle_actions_plain(cfg, state, actions, order, m)
    got = handle_actions(cfg, _to(state, device), actions.to(device), order.to(device),
                         None if m is None else m.to(device))
    return got, want


def _assert_step_equal(got, want, what):
    (gs, gr), (ws, wr) = got, want
    for k in FIELDS:
        a, b = getattr(gs, k).cpu(), getattr(ws, k).cpu()
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (what, k)
    assert torch.equal(gr.cpu().view(torch.int32), wr.cpu().view(torch.int32)), (what, 'rewards')


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_step_kernel_matches_plain(cuda_device, case):
    """``csrc/step.cu`` ≡ ``handle_actions_plain`` bit for bit over chained
    steps: every state field, the rewards' bits, with and without a mask,
    agents with no direction and off the grid, one launch a call; the input
    state is not written."""
    from multigrid_tpu_torch.core.config import EnvConfig
    w, h, n, boxes, over, e = STEP_CASES[case]
    for mask in (False, True):
        assert step_cuda.plan(e, n, w, h, boxes, mask)['variant'] == \
            ('global' if case in STEP_GLOBAL else 'staged')
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20, **over)
    rng = np.random.default_rng(list(STEP_CASES).index(case))
    fields = random_fields(int(rng.integers(1 << 30)), e, w, h, n, has_boxes=boxes,
                           max_steps=20)
    off = rng.random((e, n)) < 0.1
    fields['agent_dir'] = np.where(off, -1, fields['agent_dir']).astype(np.int32)
    fields['agent_pos'] = np.where((off & (rng.random((e, n)) < 0.5))[..., None], -1,
                                   fields['agent_pos']).astype(np.int32)
    state = to_torch(fields)
    for t in range(4):
        before = _to(state, cuda_device)
        copy = {k: getattr(before, k).clone() for k in FIELDS}
        launches = step_cuda.launches
        got, want = _step_pair(cfg, state, rng, cuda_device, mask=t % 2 == 0)
        assert step_cuda.launches == launches + 1
        _assert_step_equal(got, want, (case, t))
        state = want[0]
    for k in FIELDS:  # the kernel reads its input state only
        assert torch.equal(getattr(before, k), copy[k]), k


def test_step_kernel_views_match_plain(cuda_device):
    """State fields that are views at an offset no multiple of 16 (the
    global kernel) ≡ the plain version bit for bit, at BUP's shape and an
    env count no chunk divides; one launch."""
    from multigrid_tpu_torch.core.config import EnvConfig
    from multigrid_tpu_torch.ops.step import handle_actions, handle_actions_plain
    w, h, n, e = 11, 6, 2, 4099
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20)
    rng = np.random.default_rng(17)
    state = _to(to_torch(random_fields(17, e + 1, w, h, n, max_steps=20)), cuda_device)
    actions = torch.as_tensor(rng.integers(0, 7, (e + 1, n)).astype(np.int32), device=cuda_device)
    order = torch.as_tensor(np.argsort(rng.random((e + 1, n)), -1).astype(np.int32),
                            device=cuda_device)
    # Rows 1.. of each field: 792-byte grid rows put the views off 16.
    view = state.replace(**{k: getattr(state, k)[1:] for k in FIELDS})
    assert view.grid.data_ptr() % 16 and view.grid.is_contiguous()
    assert step_cuda.plan(e, n, w, h, True, aligned=False)['variant'] == 'global'
    want = handle_actions_plain(cfg, view, actions[1:], order[1:])
    launches = step_cuda.launches
    _assert_step_equal(handle_actions(cfg, view, actions[1:], order[1:]), want, 'views')
    assert step_cuda.launches == launches + 1


@pytest.mark.parametrize('env_id', [
    'MultiGrid-BlockedUnlockPickup-v0', 'MultiGrid-Empty-5x5-v0', 'MultiGrid-Empty-Random-5x5-v0',
    'MultiGrid-Empty-6x6-v0', 'MultiGrid-Empty-Random-6x6-v0', 'MultiGrid-Empty-8x8-v0',
    'MultiGrid-Empty-16x16-v0', 'MultiGrid-LockedHallway-2Rooms-v0',
    'MultiGrid-LockedHallway-4Rooms-v0', 'MultiGrid-LockedHallway-6Rooms-v0',
    'MultiGrid-Playground-v0', 'MultiGrid-RedBlueDoors-6x6-v0', 'MultiGrid-RedBlueDoors-8x8-v0'])
def test_step_kernel_matches_plain_on_the_zoo(cuda_device, env_id):
    """Each of the 13 configurations at 4096 envs, 2 agents, after a few
    random steps on the card: the kernel ≡ the plain version (both on the
    card) over 3 chained steps."""
    from multigrid_tpu_torch.ops.step import handle_actions, handle_actions_plain
    venv = VectorEnv(make(env_id, agents=2, device=cuda_device), 4096, reset_pool=False)
    _, state = venv.reset(seed=5)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for _ in range(3):
        _, state, *_ = venv.step(state, torch.randint(0, 7, (4096, 2), generator=g,
                                                      device=cuda_device))
    state = state.replace(pool=None)
    cfg = venv.env.cfg
    for t in range(3):
        state = state.replace(step_count=state.step_count + 1)
        actions = torch.randint(0, 7, (4096, 2), generator=g, device=cuda_device)
        order = torch.rand((4096, 2), generator=g, device=cuda_device).argsort(-1)
        want = handle_actions_plain(cfg, state, actions, order)
        got = handle_actions(cfg, state, actions, order)
        _assert_step_equal(got, want, (env_id, t))
        state = got[0]


#: The golden traces ``chip_smoke.py`` replays on the card.
STEP_GOLDEN = [('MultiGrid-Empty-16x16-v0', 3, 2), ('MultiGrid-Empty-Random-5x5-v0', 42, 4),
               ('MultiGrid-BlockedUnlockPickup-v0', 0, 2), ('MultiGrid-RedBlueDoors-6x6-v0', 0, 3),
               ('MultiGrid-LockedHallway-2Rooms-v0', 0, 2), ('MultiGrid-Playground-v0', 0, 2)]


@pytest.mark.parametrize('env_id,seed,n', STEP_GOLDEN)
def test_golden_traces_through_the_step_kernel(cuda_device, env_id, seed, n):
    """A recorded reference trajectory (``tests/golden``) through the
    parity runner on the card: observations, terminations and truncations
    equal, rewards to float32 rounding, one step launch a step."""
    import os

    from multigrid_tpu_torch.envs.parity import ParityRunner
    data = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                                f'{env_id}-s{seed}-n{n}.npz'))
    runner = ParityRunner(make(env_id, agents=n, device=cuda_device), seed)
    obs0 = runner.reset()
    images = [np.stack([obs0[i]['image'] for i in range(n)])]
    acts = np.random.default_rng(seed + 1000)
    launches = step_cuda.launches
    steps = len(data['rewards'])
    for t in range(steps):
        o, r, te, tr, _ = runner.step({i: int(acts.integers(0, 7)) for i in range(n)})
        images.append(np.stack([o[i]['image'] for i in range(n)]))
        for i in range(n):
            assert te[i] == bool(data['terms'][t, i]) and tr[i] == bool(data['truncs'][t, i])
            assert abs(r[i] - float(data['rewards'][t, i])) <= 1e-5, (t, i)
    assert step_cuda.launches == launches + steps
    np.testing.assert_array_equal(np.stack(images), data['images'].astype(np.int32))


def test_step_kernel_rejects_what_it_cannot_take(cuda_device):
    """A grid of the wrong dtype or shape: ValueError, nothing launched."""
    from multigrid_tpu_torch.core.config import EnvConfig
    from multigrid_tpu_torch.ops.step import handle_actions
    cfg = EnvConfig(width=8, height=8, num_agents=2)
    state = _to(to_torch(random_fields(0, 4, 8, 8, 2)), cuda_device)
    actions = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    order = torch.arange(2, device=cuda_device).expand(4, 2)
    launches = step_cuda.launches
    for bad in (state.replace(grid=state.grid.to(torch.int64)),
                state.replace(grid=state.grid[:, :7])):
        with pytest.raises(ValueError):
            handle_actions(cfg, bad, actions, order)
    assert step_cuda.launches == launches


# ----------------------------------------------------- training kernels


def _packed(rng, b, c, pad=0.0):
    """Packed cells with every channel in use; a share ``pad`` of them the
    pad value, which matches no channel."""
    from multigrid_tpu_torch.ops.fused_linear import PAD_CELL
    cells = (rng.integers(0, 11, (b, c)) << 8) | (rng.integers(0, 6, (b, c)) << 4) \
        | rng.integers(0, 4, (b, c))
    cells = np.where(rng.random((b, c)) < pad, PAD_CELL, cells)
    return torch.as_tensor(cells.astype(np.int32))


def _rel_err(got, want):
    """max |got - want| / (|want| + 1), the bench's tolerance measure."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (want.abs() + 1)).max())


@pytest.mark.parametrize('b,c,h,pad', [
    (16384, 49, 128, 0.0), (1001, 9, 128, 0.1), (333, 25, 32, 0.0), (77, 169, 256, 0.2),
    # per-agent and critic shapes, every width, a ragged batch with pad cells
    (4096, 49, 128, 0.0), (4096, 196, 128, 0.0), (4096, 49, 32, 0.0), (4096, 49, 64, 0.0),
    (4096, 49, 100, 0.05), (4096, 49, 256, 0.0), (4096, 196, 100, 0.05), (1001, 49, 128, 0.1),
    (1001, 49, 7, 0.1)])
def test_onehot_linear_kernel_matches_plain(cuda_device, b, c, h, pad):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(b + c + h)
    packed = _packed(rng, b, c, pad).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(c * fl.NCH, h)).astype(np.float32)).to(cuda_device)
    launches = fl.launches
    got = fl.onehot_linear_forward(packed, w)
    assert fl.launches == launches + 1
    want = fl.onehot_linear_plain(packed, w)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h)
    # bf16 output: the two differ by the rounding of differently ordered f32 sums.
    assert _rel_err(got, want) < 2e-2


@pytest.mark.parametrize('b,c,h', [(262144, 49, 128), (5000, 49, 128), (100, 9, 32),
                                   (300, 25, 256),
                                   # the centralized critic's shape, a single sample
                                   (65536, 196, 128), (1, 49, 64)])
def test_onehot_grad_kernel_matches_plain(cuda_device, b, c, h):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(b + h)
    packed = _packed(rng, b, c, 0.05).to(cuda_device)
    g = torch.as_tensor(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    launches = fl.grad_launches
    got = fl.onehot_linear_grad_w(packed, g)
    assert fl.grad_launches == launches + 1
    want = fl.onehot_linear_grad_w_plain(packed, g)
    # f32 sums of the same bf16 values in another order.
    assert float((got - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1)
    # The same from run to run: the partial sums are added in a fixed order.
    assert torch.equal(got, fl.onehot_linear_grad_w(packed, g))


def test_onehot_linear_autograd_on_the_card(cuda_device):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(7)
    packed = _packed(rng, 512, 49).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(49 * fl.NCH, 64)).astype(np.float32) * 0.1)
    w = w.to(cuda_device).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(512, 64)).astype(np.float32)).to(cuda_device)
    before = fl.launches, fl.grad_launches
    (fl.onehot_linear(packed, w).float() * g).sum().backward()
    assert (fl.launches, fl.grad_launches) == (before[0] + 1, before[1] + 1)
    want = fl.onehot_linear_grad_w_plain(packed, g)
    assert float((w.grad - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1)


def ppo_inputs(rng, b, c, h, missions, device):
    """Random ``ppo_mlp_grads`` arguments: params, cells, direction (and
    mission) features, actions, old log-probs near the policy's, normalized
    advantages and targets."""
    from multigrid_tpu_torch.learn.nets import PARAM_NAMES
    f = 2 + missions
    shapes = dict(zip(PARAM_NAMES, [(c * 21, h), (f, h), (h,), (h, h), (h,),
                                    (h, 7), (7,), (h, 1), (1,)]))
    params = {k: torch.as_tensor(
        (rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4)).astype(np.float32))
        for k, s in shapes.items()}
    theta = rng.integers(0, 4, b) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, b)]], -1)
    adv = rng.normal(size=b)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    args = [_packed(rng, b, c), torch.as_tensor(dirf.astype(np.float32)),
            torch.as_tensor(rng.integers(0, 7, b).astype(np.int32)),
            torch.as_tensor((np.log(1 / 7) + 0.3 * rng.normal(size=b)).astype(np.float32)),
            torch.as_tensor(adv.astype(np.float32)),
            torch.as_tensor(rng.normal(size=b).astype(np.float32))]
    return ({k: v.to(device) for k, v in params.items()}, [a.to(device) for a in args])


@pytest.mark.parametrize('b,h,missions', [(256, 128, 0), (256, 128, 5), (1000, 32, 0),
                                          (65536, 128, 0), (65536, 64, 0), (65536, 32, 0),
                                          (1001, 128, 0), (1001, 64, 3), (4097, 32, 5)])
def test_ppo_loss_kernel_matches_plain(cuda_device, b, h, missions):
    from multigrid_tpu_torch.ops import fused_ppo
    params, args = ppo_inputs(np.random.default_rng(b + missions), b, 49, h,
                              missions, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    launches = fused_ppo.launches
    grads, metrics = fused_ppo.ppo_mlp_grads(params, *args, **kw)
    assert fused_ppo.launches == launches + 1
    want_g, want_m = fused_ppo.ppo_mlp_grads_plain(
        params, *args, compute_dtype=torch.bfloat16, **kw)
    # bf16 operands on both sides, f32 sums in another order (bench.py:85-90).
    for k in want_g:
        assert grads[k].shape == want_g[k].shape, k
        err = float((grads[k] - want_g[k]).abs().max()) / (float(want_g[k].abs().max()) + 1e-6)
        assert err < 5e-2, (k, err)
    for k in want_m:
        err = abs(float(metrics[k]) - float(want_m[k])) / (abs(float(want_m[k])) + 1e-6)
        assert err < 5e-2, (k, err)
    # The same from run to run: per-block partials summed in a fixed order.
    again, again_m = fused_ppo.ppo_mlp_grads(params, *args, **kw)
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    for k in metrics:
        assert torch.equal(metrics[k], again_m[k]), k


# ------------------------------------- the agent axis of per-agent policies


def _agents(rng, n, b, c, pad=0.0):
    return torch.stack([_packed(rng, b, c, pad) for _ in range(n)])


@pytest.mark.parametrize('n,b,c,h', [(4, 4096, 49, 128), (2, 4096, 49, 128), (3, 1001, 9, 32),
                                     (2, 77, 25, 100), (4, 4096, 49, 64)])
def test_onehot_linear_agent_axis_is_n_single_launches(cuda_device, n, b, c, h):
    """B2 over N agents: one launch, bit-equal to N single-agent launches
    (each row computed as its agent's own launch computes it), within B2's
    tolerance of its twin, and equal from run to run."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(n + b + c + h)
    packed = _agents(rng, n, b, c, 0.05).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(n, c * fl.NCH, h)).astype(np.float32)).to(cuda_device)
    launches = fl.launches
    got = fl.onehot_linear_agents_forward(packed, w)
    assert fl.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, b, h)
    singles = torch.stack([fl.onehot_linear_forward(packed[i], w[i]) for i in range(n)])
    assert torch.equal(got, singles)
    assert _rel_err(got, fl.onehot_linear_agents_plain(packed, w)) < 2e-2
    assert torch.equal(got, fl.onehot_linear_agents_forward(packed, w))


@pytest.mark.parametrize('n,b,c,h', [(4, 65536, 49, 128), (2, 131072, 49, 128),
                                     (3, 1001, 9, 32), (2, 300, 25, 256), (4, 1, 49, 64)])
def test_onehot_grad_agent_axis_matches_plain_and_single_launches(cuda_device, n, b, c, h):
    """B3 over N agents: one launch, each agent's dW within B3's tolerance
    (1e-4 of the largest entry) of its twin and of its own launch (the
    chunks differ, so the sums' order does), equal from run to run."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(n + b + h)
    packed = _agents(rng, n, b, c, 0.05).to(cuda_device)
    g = torch.as_tensor(rng.normal(size=(n, b, h)).astype(np.float32)).to(cuda_device)
    launches = fl.grad_launches
    got = fl.onehot_linear_agents_grad_w(packed, g)
    assert fl.grad_launches == launches + 1
    assert got.shape == (n, c * fl.NCH, h)
    want = fl.onehot_linear_agents_grad_w_plain(packed, g)
    singles = torch.stack([fl.onehot_linear_grad_w(packed[i], g[i]) for i in range(n)])
    for i in range(n):
        scale = float(want[i].abs().max()) + 1
        assert float((got[i] - want[i]).abs().max()) <= 1e-4 * scale, i
        assert float((got[i] - singles[i]).abs().max()) <= 1e-4 * scale, i
    assert torch.equal(got, fl.onehot_linear_agents_grad_w(packed, g))


def _stacked_ppo_inputs(rng, n, b, h, missions, device):
    cases = [ppo_inputs(rng, b, 49, h, missions, device) for _ in range(n)]
    params = {k: torch.stack([p[k] for p, _ in cases]) for k in cases[0][0]}
    return params, [torch.stack([a[j] for _, a in cases]) for j in range(6)]


@pytest.mark.parametrize('n,b,h,missions', [(4, 65536, 128, 0), (2, 131072, 128, 12),
                                            (3, 1001, 64, 3), (2, 256, 32, 0)])
def test_ppo_loss_agent_axis_matches_plain_and_single_launches(cuda_device, n, b, h, missions):
    """B4 over N agents: one launch, each agent's gradients and metrics
    within B4's tolerance of its twin (bf16 operands) and of its own launch
    (its blocks sum in another order), equal from run to run."""
    from multigrid_tpu_torch.ops import fused_ppo
    params, args = _stacked_ppo_inputs(np.random.default_rng(n + b + missions), n, b, h,
                                       missions, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    launches = fused_ppo.launches
    grads, metrics = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
    assert fused_ppo.launches == launches + 1
    want_g, want_m = fused_ppo.ppo_mlp_grads_agents_plain(
        params, *args, compute_dtype=torch.bfloat16, **kw)
    singles = [fused_ppo.ppo_mlp_grads({k: v[i] for k, v in params.items()},
                                       *(a[i] for a in args), **kw) for i in range(n)]
    for i, (sg, sm) in enumerate(singles):
        for k in want_g:
            assert grads[k].shape == want_g[k].shape == (n,) + sg[k].shape, k
            scale = float(want_g[k][i].abs().max()) + 1e-6
            assert float((grads[k][i] - want_g[k][i]).abs().max()) / scale < 5e-2, (i, k)
            assert float((grads[k][i] - sg[k]).abs().max()) / scale < 5e-2, (i, k)
        for k in want_m:
            for ref in (want_m[k][i], sm[k]):
                err = abs(float(metrics[k][i]) - float(ref)) / (abs(float(ref)) + 1e-6)
                assert err < 5e-2, (i, k, err)
    again, again_m = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    for k in metrics:
        assert torch.equal(metrics[k], again_m[k]), k


def test_agent_axis_wrappers_raise_on_what_they_cannot_take(cuda_device):
    """No fallback: a shape, rank, width or layout the agent-axis kernels do
    not take raises ValueError on the card, and nothing launches."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    rng = np.random.default_rng(12)
    packed = _agents(rng, 2, 64, 49).to(cuda_device)
    w = torch.randn(2, 49 * fl.NCH, 128, device=cuda_device)
    g = torch.randn(2, 64, 128, device=cuda_device)
    params, args = _stacked_ppo_inputs(rng, 2, 64, 32, 0, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    before = fl.launches, fl.grad_launches, fused_ppo.launches
    bad = [lambda: fl.onehot_linear_agents_forward(packed[0], w[0]),     # no agent axis
           lambda: fl.onehot_linear_agents_forward(packed, w[:, :-21]),  # rows of another C
           lambda: fl.onehot_linear_agents_forward(packed, w[:1]),       # another N
           lambda: fl.onehot_linear_agents_forward(packed[:, ::2], w),   # not contiguous
           lambda: fl.onehot_linear_forward(packed, w),                  # agents to the single
           lambda: fl.onehot_linear_agents_grad_w(packed, g[..., :100]),  # width not built
           lambda: fl.onehot_linear_agents_grad_w(packed[0], g[0]),
           lambda: fl.onehot_linear_grad_w(packed, g),
           lambda: fused_ppo.ppo_mlp_grads_agents(
               {k: v[0] for k, v in params.items()}, *(a[0] for a in args), **kw),
           lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw),
           lambda: fused_ppo.ppo_mlp_grads_agents(
               {**params, 'img_kernel': torch.randn(2, 49 * 21, 96, device=cuda_device)},
               *args, **kw)]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert (fl.launches, fl.grad_launches, fused_ppo.launches) == before, i


@pytest.mark.parametrize('gate', [True, False], ids=['loss-kernel', 'gate-off'])
def test_per_agent_train_step_launches_once_for_all_agents(cuda_device, gate, monkeypatch):
    """Two per-agent updates on the card (2 agents): one first-layer launch
    a rollout step for all agents (5 an update) and one loss launch an SGD
    step; with the gate off one more first-layer launch and one gradient
    launch an SGD step."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    if not gate:
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device=cuda_device), 64,
                     packed_obs=True)
    config = PPOConfig(rollout_steps=4, per_agent_policies=True)
    state, net, config, tx = ppo_init(venv, 0, config=config, hidden=32,
                                      net_kwargs=dict(encoder='mlp'))
    step = make_train_step(venv, net, config, tx)
    fl.launches = fl.grad_launches = fused_ppo.launches = 0
    for _ in range(2):
        state, metrics = step(state)
    want = (10, 0, 2) if gate else (12, 2, 0)
    assert (fl.launches, fl.grad_launches, fused_ppo.launches) == want
    assert all(np.isfinite(float(metrics[k])) for k in ('loss', 'entropy', 'vf_loss'))


def test_first_layer_and_loss_kernels_run_on_the_tensor_cores(cuda_device):
    """The SASS of the first-layer kernel (B2) and of the loss kernel (B4),
    every width built, holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = {**build.tensor_core_ops('fused_linear.cu'), **build.tensor_core_ops('fused_ppo.cu')}
    for kernel in ('onehot_linear_kernel', 'ppo_loss_kernel'):
        names = [n for n in ops if kernel in n]
        assert names, kernel
        for n in names:
            assert any(op.startswith(('HMMA', 'HGMMA')) for op in ops[n]), n


def test_gradient_kernel_runs_on_the_tensor_cores(cuda_device):
    """The SASS of the weight-gradient kernel (B3), every width built,
    holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = build.tensor_core_ops('fused_linear.cu')
    names = [n for n in ops if 'onehot_grad_kernel' in n]
    assert names
    for n in names:
        assert any(op.startswith(('HMMA', 'HGMMA')) for op in ops[n]), n


def test_policy_kernel_runs_on_the_tensor_cores(cuda_device):
    """The SASS of the fused rollout-policy kernel (B5), every width built,
    holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = build.tensor_core_ops('fused_policy.cu')
    names = [n for n in ops if 'policy_sample_kernel' in n]
    assert len(names) == 4
    for n in names:
        assert any(op.startswith(('HMMA', 'HGMMA')) for op in ops[n]), n


def test_float32_nets_take_the_first_layer_kernel_on_the_card(cuda_device):
    """A float32 net on packed cells runs its first layer, and the
    centralized critic's over N·C cells, through the kernel on the card (as
    the JAX package's fused path does whatever the dtype), and agrees with
    the same net's float32 one-hot product on the CPU."""
    from multigrid_tpu_torch.learn.nets import ActorCritic, make_centralized_critic
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(11)
    image = _packed(rng, 64, 49).reshape(32, 2, 49)
    direction = torch.as_tensor(rng.integers(0, 4, (32, 2)))
    outs = []
    for dev, kernels in ((torch.device('cpu'), 0), (cuda_device, 2)):
        net = ActorCritic(49, hidden=64, packed_obs=True, dtype=torch.float32,
                          encoder='mlp').to(dev)
        critic = make_centralized_critic(net, 2).to(dev)
        before = fl.launches
        outs.append((*net(image.to(dev), direction.to(dev)),
                     critic(image.to(dev), direction.to(dev))))
        assert fl.launches == before + kernels
    for g, w in zip(outs[1], outs[0]):
        assert g.dtype == torch.float32
        assert _rel_err(g.cpu(), w) < 2e-2


def test_train_step_on_the_card(cuda_device):
    """Two PPO updates on the card: 5 forward launches per update (4 steps
    and the last value), the loss kernel once per SGD step, no dW kernel."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device=cuda_device), 64,
                     packed_obs=True)
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=4), hidden=32,
                                      net_kwargs=dict(encoder='mlp'))
    step = make_train_step(venv, net, config, tx)
    fl.launches = fl.grad_launches = fused_ppo.launches = 0
    for _ in range(2):
        state, metrics = step(state)
    assert (fl.launches, fl.grad_launches, fused_ppo.launches) == (10, 0, 2)
    assert all(np.isfinite(float(metrics[k])) for k in ('loss', 'entropy', 'vf_loss'))


def _policy_inputs(rng, b, c, h, f, device):
    """Prepared fused-policy operands (bf16 on the card), cells, direction
    (and mission) features and Gumbel noise."""
    from multigrid_tpu_torch.ops import fused_policy
    shapes = {'img_kernel': (c * 21, h), 'Dense_0.kernel': (f, h), 'Dense_0.bias': (h,),
              'Dense_1.kernel': (h, h), 'Dense_1.bias': (h,), 'Dense_2.kernel': (h, 7),
              'Dense_2.bias': (7,), 'Dense_3.kernel': (h, 1), 'Dense_3.bias': (1,)}
    params = {k: torch.as_tensor((rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4))
                                 .astype(np.float32)).to(device) for k, s in shapes.items()}
    theta = rng.integers(0, 4, b) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if f > 2:
        dirf = np.concatenate([dirf, np.eye(f - 2)[rng.integers(0, f - 2, b)]], -1)
    args = [_packed(rng, b, c, 0.05), torch.as_tensor(dirf.astype(np.float32)),
            torch.as_tensor(rng.gumbel(size=(b, 7)).astype(np.float32))]
    return fused_policy.prepare(params), [a.to(device) for a in args]


@pytest.mark.parametrize('b,c,h,f', [(16384, 49, 128, 2), (1001, 9, 32, 14),
                                     (333, 25, 256, 2), (64, 49, 64, 5)])
def test_policy_sample_kernel_matches_plain(cuda_device, b, c, h, f):
    """The fused-policy kernel ≡ its bf16 plain version: the same action on
    every row whose top-two perturbed logits are more than 1e-3 apart, the
    same log-prob where the actions agree, and the value, within
    2e-2·(|want| + 1) (sums in another order round to bf16 elsewhere)."""
    from multigrid_tpu_torch.ops import fused_policy
    w, (packed, dirf, gumbel) = _policy_inputs(np.random.default_rng(b + h), b, c, h, f,
                                               cuda_device)
    launches = fused_policy.launches
    action, logp, value = fused_policy.policy_sample_prepared(w, packed, dirf, gumbel)
    assert fused_policy.launches == launches + 1
    want_a, want_lp, want_v = fused_policy.policy_sample_plain(
        w, packed, dirf, gumbel, compute_dtype=torch.bfloat16)
    assert action.dtype == torch.int32 and action.shape == (b,)
    logits, _ = fused_policy.policy_heads_plain(w, packed, dirf, compute_dtype=torch.bfloat16)
    top2 = (logits + gumbel).topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(action[clear], want_a[clear])
    same = action == want_a
    assert float(((logp - want_lp).abs() / (want_lp.abs() + 1))[same].max()) < 2e-2
    assert float(((value - want_v).abs() / (want_v.abs() + 1)).max()) < 2e-2


def test_policy_sample_kernel_takes_the_first_index_on_a_tie(cuda_device):
    """Two identical Wa columns and biases and equal noise, far above the
    other actions: the kernel picks the lower index on every row."""
    from multigrid_tpu_torch.ops import fused_policy
    w, (packed, dirf, gumbel) = _policy_inputs(np.random.default_rng(3), 4096, 49, 128, 2,
                                               cuda_device)
    w['wa'][:, 5] = w['wa'][:, 2]
    w['ba'][:] = -30.0
    w['ba'][[2, 5]] = 1.0
    gumbel[:] = 0.0
    gumbel[:, [2, 5]] = 0.25
    action, _, _ = fused_policy.policy_sample_prepared(w, packed, dirf, gumbel)
    assert (action == 2).all()


def _state_to(state, device):
    """A batched state, extras and pool included, on ``device``."""
    from multigrid_tpu_torch.core.state import ResetPool
    pool = state.pool and ResetPool(_state_to(state.pool.reserve, device), state.pool.step,
                                    None if state.pool.keys is None else state.pool.keys.to(device))
    return state.replace(**{k: getattr(state, k).to(device) for k in STATE_FIELDS},
                         extras={k: v.to(device) for k, v in state.extras.items()}, pool=pool)


def test_pool_consumption_on_the_card_matches_the_cpu(cuda_device):
    """BUP, 64 envs, episodes of 3 steps, from the same state, keys and
    reserve on both devices, the same actions, ``refresh=False``: every
    step's state (fields with the keys, extras, pool step) and observations
    equal the CPU path's, the orders drawn from the keys (R2 on the card),
    three rounds of resets from the reserve included."""
    env_id, e = 'MultiGrid-BlockedUnlockPickup-v0', 64
    cpu = VectorEnv(make(env_id, agents=2, max_steps=3, device='cpu'), e, packed_obs=True)
    card = VectorEnv(make(env_id, agents=2, max_steps=3, device=cuda_device), e,
                     packed_obs=True)
    assert cpu.reset_pool and card.reset_pool
    _, state = cpu.reset(seed=3)
    gstate = _state_to(state, cuda_device)
    g = torch.Generator().manual_seed(3)
    dones = 0
    for t in range(9):
        actions = torch.randint(0, 7, (e, 2), generator=g)
        obs, state, *_, done, _ = cpu.step(state, actions, refresh=False)
        gobs, gstate, *_, gdone, _ = card.step(gstate, actions.to(cuda_device), refresh=False)
        assert torch.equal(gdone.cpu(), done) and torch.equal(gobs['image'].cpu(), obs['image'])
        for k in STATE_FIELDS:
            assert torch.equal(getattr(gstate, k).cpu(), getattr(state, k)), (t, k)
        for k, v in state.extras.items():
            assert torch.equal(gstate.extras[k].cpu(), v), (t, k)
        assert gstate.pool.step == state.pool.step == t + 1
        dones += int(done.sum())
    assert dones == 3 * e


def test_cnn_on_the_card_matches_cpu_float32(cuda_device):
    """The cnn (bf16 on the card, cuDNN convolutions) against the float32
    net on the CPU with the same weights, on packed cells with 12 missions,
    as chip_smoke.py's cnn check holds them: logits and values within
    ``max|Δ|/(|want|+1) < 2e-2``, each parameter's gradient of a scalar of
    them within ``‖Δ‖/‖want‖ < 0.1`` (bf16 rounds activations and
    gradients at each of the five layers above ``Conv_0``; an element of a
    gradient summed over many samples can cancel to near 0)."""
    from multigrid_tpu_torch.learn.nets import ActorCritic
    rng = np.random.default_rng(8)
    b = 2048
    image = _packed(rng, b, 81, 0.0)
    direction = torch.as_tensor(rng.integers(0, 4, b))
    mission = torch.as_tensor(rng.integers(0, 12, b))
    u = torch.as_tensor(rng.normal(size=(b, 7)).astype(np.float32))
    outs = []
    for dev, dtype in ((torch.device('cpu'), torch.float32), (cuda_device, torch.bfloat16)):
        net = ActorCritic(81, hidden=64, packed_obs=True, num_missions=12, dtype=dtype,
                          encoder='cnn', seed=4).to(dev)
        logits, value = net(image.to(dev), direction.to(dev), mission.to(dev))
        ((logits * u.to(dev)).sum() + value.sum()).backward()
        outs.append([logits.detach().cpu(), value.detach().cpu()]
                    + [p.grad.cpu() for _, p in sorted(net.named_parameters())])
    for g, w in zip(outs[1][:2], outs[0][:2]):
        assert _rel_err(g, w) < 2e-2
    for g, w in zip(outs[1][2:], outs[0][2:]):
        assert float((g.float() - w).norm() / w.norm()) < 0.1


def test_per_agent_cnn_one_pass_on_the_card(cuda_device):
    """Per-agent cnn actors as one pass (``apply_per_agent``: each
    convolution one ``conv2d`` of a block-diagonal kernel, bf16, cuDNN,
    channels-last) against the agent
    loop (``apply_per_agent_loop``) on the card and against the float32
    loop on the CPU with the same weights, 3 agents on packed cells with 12
    missions: logits and values within ``max|Δ|/(|want|+1) < 2e-2``; each
    parameter's gradient of a scalar of them within ``‖Δ‖/‖want‖ < 5e-2``
    of the card's loop and ``< 0.1`` of the CPU's float32 (as the shared
    cnn's card test holds it)."""
    from multigrid_tpu_torch.learn.nets import (
        ActorCritic,
        apply_per_agent,
        apply_per_agent_loop,
    )
    rng = np.random.default_rng(9)
    b, n = 1024, 3
    image = _packed(rng, b * n, 81, 0.0).reshape(b, n, 81)
    direction = torch.as_tensor(rng.integers(0, 4, (b, n)))
    mission = torch.as_tensor(rng.integers(0, 12, (b, n)))
    u = torch.as_tensor(rng.normal(size=(b, n, 7)).astype(np.float32))
    nets = [ActorCritic(81, hidden=64, packed_obs=True, num_missions=12, encoder='cnn', seed=i)
            for i in range(n)]
    params = {k: torch.stack([dict(m.named_parameters())[k].detach() for m in nets])
              for k, _ in nets[0].named_parameters()}
    outs = {}
    for name, fn, dev, dtype in (('cpu loop', apply_per_agent_loop, 'cpu', torch.float32),
                                 ('card loop', apply_per_agent_loop, cuda_device, torch.bfloat16),
                                 ('card one pass', apply_per_agent, cuda_device, torch.bfloat16)):
        net = ActorCritic(81, hidden=64, packed_obs=True, num_missions=12, dtype=dtype,
                          encoder='cnn').to(dev)
        leaves = {k: v.to(dev).clone().requires_grad_(True) for k, v in params.items()}
        logits, value = fn(net, leaves, image.to(dev), direction.to(dev), mission.to(dev))
        ((logits * u.to(dev)).sum() + value.sum()).backward()
        outs[name] = [logits.detach().cpu(), value.detach().cpu()] + [
            leaves[k].grad.cpu() for k in sorted(leaves)]
    got = outs['card one pass']
    for want, grad_tol in ((outs['card loop'], 5e-2), (outs['cpu loop'], 0.1)):
        for g, w in zip(got[:2], want[:2]):
            assert _rel_err(g, w) < 2e-2
        for g, w in zip(got[2:], want[2:]):
            assert float((g.float() - w.float()).norm() / w.float().norm()) < grad_tol


def test_resume_on_the_card_is_exact(cuda_device, tmp_path):
    """BUP on the card (mlp on B2 and B4, the pool): 2 updates straight ≡ 1
    update, a checkpoint, a restore into freshly built objects and 1 more,
    bit for bit (B3 and B4 are equal from run to run)."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    def setup(seed):
        venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=5,
                              device=cuda_device), 64, packed_obs=True)
        state, net, config, tx = ppo_init(venv, seed, hidden=32, config=PPOConfig(
            rollout_steps=4, epochs=2, minibatches=2), net_kwargs=dict(encoder='mlp'))
        return venv, state, make_train_step(venv, net, config, tx)

    venv, state, step = setup(0)
    state, _ = step(state)
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    straight, _ = step(state)
    venv2, fresh, step2 = setup(1)
    resumed, _ = step2(restore_checkpoint(path, fresh, venv2))
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
    for k in STATE_FIELDS:
        assert torch.equal(getattr(resumed.env_state, k), getattr(straight.env_state, k)), k
    assert torch.equal(resumed.env_state.pool.reserve.grid, straight.env_state.pool.reserve.grid)
    assert torch.equal(resumed.env_state.pool.keys, straight.env_state.pool.keys)
    assert torch.equal(resumed.key, straight.key)


# ------------------------------------------------ the user-facing surface


def _obs_to(obs, device):
    if isinstance(obs, dict):
        return {k: v.to(device) for k, v in obs.items()}
    return obs.to(device)


def _obs_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_obs_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('name', ['FullyObsWrapper', 'ImgObsWrapper', 'OneHotObsWrapper'])
def test_wrapped_vector_env_on_the_card_matches_the_cpu(cuda_device, name):
    """BUP on the pool under each wrapper, 64 envs, episodes of 3 steps,
    from the same state and reserve on both devices, the same actions and
    orders (drawn from the same keys), ``refresh=False``: every step's
    wrapped observations equal the CPU path's, one obs launch a step."""
    from multigrid_tpu_torch import wrappers
    env_id, e = 'MultiGrid-BlockedUnlockPickup-v0', 64
    cpu, card = (VectorEnv(getattr(wrappers, name)(make(env_id, agents=2, max_steps=3,
                                                        device=d)), e)
                 for d in ('cpu', cuda_device))
    obs, state = cpu.reset(seed=3)
    gstate = _state_to(state, cuda_device)
    assert _obs_equal(_obs_to(card.observe(gstate), 'cpu'), obs)
    g = torch.Generator().manual_seed(3)
    dones = 0
    for t in range(9):
        actions = torch.randint(0, 7, (e, 2), generator=g)
        obs, state, *_, done, _ = cpu.step(state, actions, refresh=False)
        launches = obs_cuda.launches
        gobs, gstate, *_ = card.step(gstate, actions.to(cuda_device), refresh=False)
        assert obs_cuda.launches == launches + 1
        assert _obs_equal(_obs_to(gobs, 'cpu'), obs), t
        dones += int(done.sum())
    assert dones == 3 * e


def test_adapters_launch_the_obs_kernel_once_a_call(cuda_device):
    """A ``GymAdapter`` over BUP keeps its state on the card and launches
    the obs kernel once a reset and once a step; a ``MiniGridCompatEnv``
    (host-side layouts uploaded to the card) through the MiniGrid facade
    does the same, its observations equal to the plain version's."""
    from multigrid_tpu_torch.adapters import GymAdapter
    from multigrid_tpu_torch.utils.minigrid_builder import Goal, Grid, MiniGridCompatEnv
    from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface

    ad = GymAdapter(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device=cuda_device))
    launches = obs_cuda.launches
    ad.reset(seed=0)
    assert obs_cuda.launches == launches + 1 and ad._state.device.type == cuda_device.type
    for t in range(10):
        ad.step({0: t % 7} if t % 3 else {0: 2, 1: t % 7})
        assert obs_cuda.launches == launches + 2 + t

    class Room(MiniGridCompatEnv):
        mission = 'get to the green goal square'

        def _gen_grid(self, width, height):
            self.grid = Grid(width, height)
            self.grid.wall_rect(0, 0, width, height)
            self.put_obj(Goal(), width - 2, height - 2)
            self.place_agent()

    mg = MiniGridInterface(Room(grid_size=7, device=cuda_device))
    launches = obs_cuda.launches
    obs, _ = mg.reset(seed=1)
    for t, a in enumerate([2, 1, 2, 0, 2, 2]):
        want = gen_obs_batched_plain(_to(mg._state, 'cpu'), 7, False)[0, 0].numpy()
        np.testing.assert_array_equal(obs['image'], want)
        obs, *_ = mg.step(a)
        assert obs_cuda.launches == launches + 2 + t


@pytest.mark.parametrize('backend,procs', [('nccl', 1), ('gloo', 2)])
def test_sharded_training_on_the_card_matches_one_process(cuda_device, backend, procs):
    """PPO over processes on the card (spawned, a file-store rendezvous):
    NCCL in a world of one equals the plain path; two gloo processes
    sharing the card (NCCL refuses two on one card) match one process at
    rtol 1e-4 with the first rollout bit-equal. Each process launches B1 T,
    B2 T + 1 and B4 once an update, R2 and M1 once a rollout step and R1 twice
    (the key's split and the Gumbel noise of its rows)."""
    from multigrid_tpu_torch.parallel.dryrun import assert_consistent, ppo_run, spawn

    kw = dict(num_envs=512, updates=2, env_id='MultiGrid-Empty-16x16-v0', agents=4,
              hidden=128, config=dict(rollout_steps=4), device='cuda')
    sharded = spawn(ppo_run, procs, (), kw, backend=backend, device='cuda', timeout=300)
    single = ppo_run(**kw, sharded=False)
    assert_consistent(sharded, single, f'{backend} x {procs}',
                      **(dict(rtol=0.0, atol=0.0) if procs == 1 else {}))
    for res in sharded:
        assert res['launches'] == {'obs': 8, 'obs_general': 0, 'onehot_linear': 10,
                                   'onehot_linear_grad': 0, 'ppo_loss': 2,
                                   'policy_sample': 0, 'step': 8, 'threefry': 8,
                                   'step_draws': 8, 'reset_merge': 8}


def test_model_axis_gate_on_the_card_is_one_process(cuda_device):
    """``dryrun_multichip(2)`` on the card, two gloo processes sharing it:
    the JAX gate's (1, 2) mesh and cnn, each process holding half of
    Dense_0's columns, bit for bit against one process; B1 T an update
    a process, R2 and M1 once a step and R1 twice (the cnn launches no
    other kernel)."""
    from multigrid_tpu_torch.parallel.dryrun import assert_consistent, dryrun_multichip

    sharded, single = dryrun_multichip(2, backend='gloo', device='cuda', timeout=300)
    assert [r['mesh_shape'] for r in sharded] == [[1, 2], [1, 2]]
    assert_consistent(sharded, single, '(1, 2) gate', rtol=0.0, atol=0.0)
    for res in sharded:
        assert res['encoder'] == 'cnn'
        assert res['launches'] == {'obs': 6, 'obs_general': 0, 'onehot_linear': 0,
                                   'onehot_linear_grad': 0, 'ppo_loss': 0, 'policy_sample': 0,
                                   'step': 6, 'threefry': 6, 'step_draws': 6,
                                   'reset_merge': 6}



# ----------------------------------------- CUDA graphs against the eager loop

def _states_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.extras.keys() == b.extras.keys()
    for k in a.extras:
        assert torch.equal(a.extras[k], b.extras[k]), k
    assert (a.pool is None) == (b.pool is None)
    if a.pool is not None:
        assert torch.equal(a.pool.step, b.pool.step)
        assert torch.equal(a.pool.keys, b.pool.keys)
        _states_equal(a.pool.reserve, b.pool.reserve)


@pytest.mark.parametrize('env_id,agents,steps', [
    ('MultiGrid-Empty-16x16-v0', 4, 40), ('MultiGrid-BlockedUnlockPickup-v0', 2, 40)],
    ids=['flagship', 'bup-pool'])
def test_graphed_rollout_random_equals_eager(cuda_device, env_id, agents, steps):
    """``rollout_random`` replaying its graphs (the env flagship: a one-step
    graph; BUP on the reserve pool: two chunk graphs and 8 one-step
    replays) ≡ the eager loop under ``disable_graphs()`` from the same seed:
    states with the pool, observations of the final state and the summary,
    bit for bit; one obs launch and one step launch a step counted through
    the replays."""
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    runs = []
    for graphed in (True, False):
        venv = VectorEnv(make(env_id, agents=agents, device=cuda_device), 4096)
        assert venv.reset_pool == (env_id != 'MultiGrid-Empty-16x16-v0')
        _, state = venv.reset(seed=3)
        with contextlib.nullcontext() if graphed else disable_graphs():
            assert venv.graphed() == graphed
            launches = obs_cuda.launches, step_cuda.launches
            state, summary = venv.rollout_random(state, 4, steps)
            assert (obs_cuda.launches, step_cuda.launches) == (launches[0] + steps,
                                                               launches[1] + steps)
            state, summary = venv.rollout_random(state, 5, steps)
        runs.append((state, summary, venv.observe(state)))
    (a, sa, oa), (b, sb, ob) = runs
    _states_equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa), (sa, sb)
    assert all(torch.equal(oa[k], ob[k]) for k in oa)


@pytest.mark.parametrize('fused', [False, True], ids=['default', 'fused-policy'])
def test_graphed_train_updates_equal_eager(cuda_device, fused, monkeypatch):
    """Three trained-flagship updates (Empty-16x16, 4 agents, 4096 envs,
    mlp 128 on packed cells, T 16, 2 epochs x 2 minibatches, the rate
    annealed) replaying the update's graph ≡ three eager updates from the
    same seed: parameters, Adam's moments and counts, the env state and
    every metric bit for bit, and the launch counts alike."""
    from multigrid_tpu_torch.learn import (
        PPOConfig,
        linear_schedule,
        make_train_loop,
        make_train_step,
        ppo_init,
    )
    from multigrid_tpu_torch.ops import launch_counts, zero_launch_counts
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    if fused:
        monkeypatch.setenv('MULTIGRID_FUSED_POLICY', '1')
    runs = []
    for graphed in (True, False):
        venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=4, device=cuda_device), 4096,
                         packed_obs=True)
        state, net, config, tx = ppo_init(
            venv, 0, config=PPOConfig(rollout_steps=16, epochs=2, minibatches=2),
            net_kwargs=dict(encoder='mlp'), lr_schedule=linear_schedule(3e-4, 0.0, 100))
        step = make_train_step(venv, net, config, tx)
        loop = make_train_loop(venv, net, config, tx, 2)
        with contextlib.nullcontext() if graphed else disable_graphs():
            state, first = step(state)
            zero_launch_counts()
            state, means = loop(state)
            counts = launch_counts()
        assert step.fused_policy == fused
        runs.append((state, first, means, counts))
    (a, fa, ma, ca), (b, fb, mb, cb) = runs
    assert ca == cb and ca['obs'] == ca['step'] == 32 and ca['ppo_loss'] == 8, (ca, cb)
    assert ca['policy_sample' if fused else 'onehot_linear'] >= 32
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    assert int(a.opt_state.count) == int(b.opt_state.count) == 12
    assert torch.equal(a.opt_state.schedule_count, b.opt_state.schedule_count)
    _states_equal(a.env_state, b.env_state)
    assert torch.equal(a.ep_return_acc, b.ep_return_acc)
    assert torch.equal(a.key, b.key)
    for x, y in ((fa, fb), (ma, mb)):
        for k in x:
            assert torch.equal(x[k], y[k]) or (x[k].isnan() and y[k].isnan()), k


def test_graphed_gym_adapter_episode_equals_eager(cuda_device):
    """A ``GymAdapter`` over BUP replaying the env's reset and step graphs
    ≡ the same episode under ``disable_graphs()``: every observation,
    reward and termination, with partial action dicts."""
    from multigrid_tpu_torch.adapters import GymAdapter
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    runs = []
    for graphed in (True, False):
        ad = GymAdapter(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device=cuda_device))
        rng = np.random.default_rng(5)
        out = []
        with contextlib.nullcontext() if graphed else disable_graphs():
            obs, _ = ad.reset(seed=4)
            out.append(obs)
            for _ in range(80):
                actions = {i: int(rng.integers(7)) for i in range(2) if rng.random() < 0.8}
                obs, rew, term, trunc, _ = ad.step(actions)
                out.append((obs, rew, term, trunc))
                if all(term.values()) or any(trunc.values()):
                    out.append(ad.reset()[0])
        runs.append(out)
    assert len(runs[0]) == len(runs[1])
    for x, y in zip(*runs):
        obs_x, obs_y = (x[0], y[0]) if isinstance(x, tuple) else (x, y)
        for i in obs_x:
            np.testing.assert_array_equal(obs_x[i]['image'], obs_y[i]['image'])
            assert obs_x[i]['direction'] == obs_y[i]['direction']
        if isinstance(x, tuple):
            assert x[1:] == y[1:]


# ------------------------------- an NCCL mesh's graphs and the CLIs' scans

@pytest.fixture
def nccl_world(cuda_device, tmp_path):
    """This process as a world of one over NCCL (the only NCCL group one
    card holds: NCCL refuses two processes on one card), so that a mesh's
    collectives are real NCCL calls over one rank."""
    from multigrid_tpu_torch.parallel import distributed
    distributed.join(f'file://{tmp_path / "store"}', 1, 0, backend='nccl', device=cuda_device)
    try:
        yield cuda_device
    finally:
        distributed.shutdown()


@pytest.fixture
def replays(monkeypatch):
    """The graphs replayed meanwhile, one entry a replay."""
    from multigrid_tpu_torch.utils import graphs
    seen, replay = [], graphs.Graph.replay

    def counted(self):
        seen.append(self)
        return replay(self)
    monkeypatch.setattr(graphs.Graph, 'replay', counted)
    return seen


def test_nccl_collectives_replay_in_a_graph(nccl_world):
    """A sum and a max all-reduce (float32, float64) and the one-buffer
    gather along dims 0-2, captured in one graph over the world of one:
    each replay equals the eager collectives on the buffer's values then."""
    import torch.distributed as dist

    from multigrid_tpu_torch.parallel import distributed
    from multigrid_tpu_torch.utils.graphs import Graph
    world = dist.group.WORLD

    def fn(x):
        return [distributed.all_reduce(x * 2, world),
                distributed.all_reduce(x.double(), world, op='max')] + [
            distributed.all_gather_rows(x[:, :, :3] + 1, world, d) for d in range(3)]
    x = torch.randn(6, 5, 4, device=nccl_world)
    graph = Graph(fn, x, group=world)
    for _ in range(2):
        got, want = graph.replay(), fn(x)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        x.add_(1)


def test_nccl_shift_rows_replays_in_a_graph(nccl_world):
    """The reserve pool's exchange (``shift_rows``, an all-to-all with fixed
    split sizes) captured in a graph over the world of one, its one rank
    both peers: each replay gives the buffer's rows then, as eagerly."""
    import torch.distributed as dist

    from multigrid_tpu_torch.parallel import distributed
    from multigrid_tpu_torch.utils.graphs import Graph
    world = dist.group.WORLD

    def fn(x):
        return [distributed.shift_rows(x + 1, world, 0, 0)]
    x = torch.randint(0, 1000, (2048, 97), dtype=torch.int32, device=nccl_world)
    graph = Graph(fn, x, group=world)
    for _ in range(2):
        got = graph.replay()
        assert torch.equal(got[0], x + 1) and torch.equal(fn(x)[0], x + 1)
        x.add_(1)


@pytest.mark.parametrize('per_agent', [False, True], ids=['default', 'per-agent'])
def test_nccl_mesh_graphed_updates_equal_eager_and_one_process(nccl_world, replays, per_agent):
    """``TrainStep.run`` of 3 trained-flagship updates (Empty-16x16, 4
    agents, 4096 envs, mlp 128 on packed cells, T 16) on an NCCL mesh,
    replaying one graph an update with the collectives inside ≡ the same
    under ``disable_graphs()`` ≡ one process's graphed updates: parameters,
    Adam's state, the env state with its keys, the metrics and the
    learner's key bit for bit; the launches B1 48, B2 51, B4 3 in each."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import launch_counts, zero_launch_counts
    from multigrid_tpu_torch.parallel import make_mesh
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    runs = []
    for mesh, graphed in ((make_mesh(), True), (make_mesh(), False), (None, True)):
        venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=4, device=nccl_world), 4096,
                         packed_obs=True, mesh=mesh)
        state, net, config, tx = ppo_init(
            venv, 0, config=PPOConfig(rollout_steps=16, per_agent_policies=per_agent),
            net_kwargs=dict(encoder='mlp'))
        step = make_train_step(venv, net, config, tx)
        with contextlib.nullcontext() if graphed else disable_graphs():
            assert venv.graphed() == graphed
            replays.clear()
            zero_launch_counts()
            state, rows = step.run(state, 3)
            counts = launch_counts()
        assert len(replays) == (3 if graphed else 0) and len(step._graphs) == int(graphed)
        # R1: the split and Gumbel noise a rollout step, one launch; R2
        # once a step.
        assert counts == {'obs': 48, 'obs_general': 0, 'onehot_linear': 51,
                          'onehot_linear_grad': 0, 'ppo_loss': 3, 'policy_sample': 0,
                          'step': 48, 'threefry': 48, 'step_draws': 48,
                          'reset_merge': 48}, counts
        runs.append((state, rows))
    a, rows_a = runs[-1]
    for b, rows_b in runs[:-1]:
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
            assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
            assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
        assert torch.equal(a.opt_state.count, b.opt_state.count)
        _states_equal(a.env_state, b.env_state)
        assert torch.equal(a.ep_return_acc, b.ep_return_acc)
        for x, y in zip(rows_a, rows_b):
            for k in x:
                assert torch.equal(x[k], y[k]) or (x[k].isnan() and y[k].isnan()), k
        assert torch.equal(a.key, b.key)


def test_nccl_mesh_rollout_and_step_replay_graphs(nccl_world, replays):
    """``rollout_random`` (BUP on the reserve pool, 4096 envs, 40 steps:
    two chunk replays and 8 one-step replays, the summary's all-reduces
    after them) and ``step`` on an NCCL mesh ≡ the same under
    ``disable_graphs()`` ≡ one process's graphed run, bit for bit."""
    from multigrid_tpu_torch.parallel import make_mesh
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    runs = []
    for mesh, graphed in ((make_mesh(), True), (make_mesh(), False), (None, True)):
        venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device=nccl_world),
                         4096, mesh=mesh)
        _, state = venv.reset(seed=3)
        gen = torch.Generator(device=nccl_world).manual_seed(4)
        with contextlib.nullcontext() if graphed else disable_graphs():
            assert venv.graphed() == graphed
            replays.clear()
            state, summary = venv.rollout_random(state, 4, 40)
            actions = torch.randint(0, 7, (4096, 2), generator=gen, device=nccl_world)
            obs, state, *rest = venv.step(state, actions)
        assert len(replays) == (2 + 8 + 1 if graphed else 0)
        runs.append((state, summary, obs, rest))
    (a, sa, oa, ra) = runs[-1]
    for b, sb, ob, rb in runs[:-1]:
        _states_equal(a, b)
        assert all(torch.equal(sa[k], sb[k]) for k in sa), (sa, sb)
        assert all(torch.equal(oa[k], ob[k]) for k in oa)
        assert all(torch.equal(x, y) for x, y in zip(ra, rb))


def test_graphed_evaluate_and_probe_equal_eager(cuda_device, tmp_path, replays):
    """``evaluate`` (BUP on the pool, 1024 envs, 3 iterations of 256 steps:
    one replay of its one-step graph a step) and ``probe_random_success.probe`` (BUP,
    1024 envs, 300 steps: one replay a step) ≡ the same under
    ``disable_graphs()``: the JSON rows but the rate, bit for bit, and the
    launches alike."""
    from multigrid_tpu_torch import evaluate, probe_random_success
    from multigrid_tpu_torch.learn import ppo_init
    from multigrid_tpu_torch.ops import launch_counts, zero_launch_counts
    from multigrid_tpu_torch.utils.checkpoint import save_checkpoint
    from multigrid_tpu_torch.utils.graphs import disable_graphs
    bup = 'MultiGrid-BlockedUnlockPickup-v0'
    venv = VectorEnv(make(bup, agents=2, device=cuda_device), 1024, packed_obs=True)
    state, *_ = ppo_init(venv, 7, net_kwargs=dict(encoder='mlp'))
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    runs = []
    for graphed in (True, False):
        with contextlib.nullcontext() if graphed else disable_graphs():
            replays.clear()
            zero_launch_counts()
            row = evaluate.main(['--env', bup, '--num-envs', '1024', '--num-steps',
                                 str(3 * 256 * 1024 * 2), '--encoder', 'mlp',
                                 '--checkpoint', path])
            ev = (len(replays), launch_counts())
            replays.clear()
            probed = probe_random_success.probe(bup, 2, 1024, 300, 0)
        assert len(replays) == (300 if graphed else 0)
        assert ev[0] == (3 * 256 if graphed else 0)
        row.pop('eval_agent_steps_per_sec')
        assert row['episodes'] > 0 and probed['episodes'] > 0
        runs.append((row, probed, ev[1]))
    assert runs[0] == runs[1]
    assert runs[0][2]['obs'] == 3 * 257 + 2  # and the two resets
    assert runs[0][2]['step'] == 3 * 256


# ------------------------------------------------ the keyed draws (R1, R2)


@pytest.mark.parametrize('mode', [prng.PAIR, prng.BITS, prng.UNIFORM, prng.GUMBEL,
                                  prng.RANDINT])
@pytest.mark.parametrize('k,count,offset', [(4096, 2, 0), (1, 16384, 0), (1, 16384, 16384),
                                            (16387, 4, 2**32 + 3), (37, 1024, 5)])
def test_threefry_kernel_matches_plain(cuda_device, mode, k, count, offset):
    """R1 ≡ its plain version, both on the card, ``torch.equal``, in every
    mode, with offsets (a process's rows, an index past 2**32), one launch
    a call."""
    from multigrid_tpu_torch.ops import prng_cuda
    keys = prng.split(prng.key(k + count, cuda_device), k)
    spans = torch.tensor([7, 4, 1000, 0], device=cuda_device)
    kw = dict(spans=spans, minval=-2, fmin=-1.0, fmax=2.5)
    launches = prng_cuda.launches
    got = prng_cuda.draw(keys, count, offset, mode, **kw)
    assert prng_cuda.launches == launches + 1
    assert torch.equal(got, prng.draw_plain(keys, count, offset, mode, **kw))


@pytest.mark.parametrize('mode', [prng.PAIR, prng.BITS, prng.UNIFORM, prng.GUMBEL,
                                  prng.RANDINT])
@pytest.mark.parametrize('k,count,offset', [(1, 16384, 0), (1, 114688, 0), (1, 16384, 16384),
                                            (37, 5, 2**32 + 3), (16387, 2, 0), (5, 0, 0)])
def test_threefry_kernel_split_first_matches_plain(cuda_device, mode, k, count, offset):
    """R1's split prologue ≡ the plain split then draw, both on the card,
    ``torch.equal`` (the carried keys and the draw), every mode, one launch
    a call; with an offset read on the device too."""
    from multigrid_tpu_torch.ops import prng_cuda
    keys = prng.split(prng.key(k + count + 1, cuda_device), k)
    spans = torch.tensor([7, 4, 1000, 0], device=cuda_device)
    kw = dict(spans=spans, minval=-2, fmin=-1.0, fmax=2.5, split_first=True)
    for off in (offset, torch.tensor(offset, dtype=torch.int64, device=cuda_device)):
        launches = prng_cuda.launches
        got = prng_cuda.draw(keys, count, off, mode, **kw)
        assert prng_cuda.launches == launches + 1
        want = prng.draw_plain(keys, count, offset, mode, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_threefry_kernel_reads_its_offset_on_the_device(cuda_device):
    """``fold_in`` by a 0-d device tensor (the pool's step), in a CUDA graph
    replayed after the step changed: the draw follows the device value."""
    from multigrid_tpu_torch.utils.graphs import Graph
    keys = prng.split(prng.key(3, cuda_device), 64)
    step = torch.zeros((), dtype=torch.int64, device=cuda_device)
    graph = Graph(lambda s: prng.fold_in(keys, s), step)
    for g in (0, 5, 2**31 + 7):
        step.fill_(g)
        assert torch.equal(graph.replay(), prng.fold_in(keys.cpu(), g).to(cuda_device))


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('e,n', [(4096, 4), (4096, 2), (16387, 4), (2048, 64), (33, 1),
                                 (4096, 3), (4096, 5), (4096, 6), (4096, 7), (4096, 8),
                                 (4096, 9), (4096, 16), (8192, 64), (40000, 4)])
def test_step_draws_kernel_matches_plain(cuda_device, mode, e, n):
    """R2 ≡ its plain version on the card, ``torch.equal`` (orders with
    ties at 64 agents, keys), one launch a call; and ≡ the CPU's. Teams of
    1 to 8 take the unrolled instances, 9 to 64 the generic body."""
    from multigrid_tpu_torch.ops import prng_cuda
    rng = prng.split(prng.key(e + n, cuda_device), e)
    launches = prng_cuda.step_launches
    got = prng_cuda.step_draws(rng, n, mode)
    assert prng_cuda.step_launches == launches + 1
    for g, w, c in zip(got, prng.step_draws_plain(rng, n, mode),
                       prng.step_draws_plain(rng.cpu(), n, mode)):
        assert (g is None) == (w is None) == (c is None)
        if g is not None:
            assert torch.equal(g, w) and torch.equal(g.cpu(), c)
    with pytest.raises(ValueError):
        prng_cuda.step_draws(rng, prng.MAX_STEP_AGENTS + 1, mode)


def test_streams_on_the_card_are_the_jax_packages(cuda_device):
    """The runs of ``tests/torch_jax_streams.json`` on the card: every
    step's digest the JAX package's (the file's)."""
    from . import torch_streams
    want = torch_streams.load()['runs']
    for name in torch_streams.RUNS:
        got = torch_streams.port_run(name, cuda_device)
        assert got['steps'] == want[name]['steps'], name


# --------------------------------------------- spans and stage counters (tracing)

def _device_names(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return ({e.name for e in events if e.device_type == DeviceType.CUDA},
            {e.name for e in events if e.device_type == DeviceType.CPU})


def test_graphs_without_counting_hold_no_mark_and_spans_stay_on_the_host(cuda_device):
    """A rollout's graphs captured with the stage counters off launch no
    mark and the same kernels a step as before (one obs, one step launch);
    the ``mgt.*`` spans are on the host's timeline of a profile, and none
    of them on the device's."""
    venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device=cuda_device),
                     1024, packed_obs=True)
    _, state = venv.reset(seed=3)
    state, _ = venv.rollout_random(state, 1, 18)
    launches = obs_cuda.launches, step_cuda.launches
    device, host = _device_names(lambda: venv.rollout_random(state, 2, 18))
    assert (obs_cuda.launches, step_cuda.launches) == (launches[0] + 18, launches[1] + 18)
    assert not any('stage_mark' in n for n in device), sorted(device)
    assert not any(n.startswith('mgt.') for n in device)
    assert {'mgt.rollout', 'mgt.graph.load', 'mgt.graph.replay', 'mgt.graph.clone'} <= host


@pytest.mark.parametrize('env_id,agents,steps', [
    ('MultiGrid-Empty-16x16-v0', 4, 64), ('MultiGrid-BlockedUnlockPickup-v0', 2, 64)],
    ids=['flagship', 'bup-pool'])
def test_marked_replays_sum_to_the_events_and_change_no_bit(cuda_device, env_id, agents,
                                                            steps):
    """With the stage counters on, a graphed rollout's stage table (4096
    envs) sums, ``between`` and ``graph`` included, to the CUDA events'
    time around the stretch within 2 %; each env stage closes once a step
    (the reset none at the pool, whose layouts the merge kernel reads);
    ``layouts.used`` is the summary's episodes, ``layouts.made`` E a step
    (the exact reset) or the refreshes' slots; state and summary are the
    bits of the same rollout with counting off. The clock's tick is under
    a microsecond."""
    from multigrid_tpu_torch.utils import profiling
    runs = []
    for on in (True, False):
        venv = VectorEnv(make(env_id, agents=agents, max_steps=40, device=cuda_device), 4096)
        _, state = venv.reset(seed=5)
        with profiling.stage_counters() if on else contextlib.nullcontext():
            state, _ = venv.rollout_random(state, 1, steps)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            if on:
                profiling.zero_stages(cuda_device)
            state, summary = venv.rollout_random(state, 2, steps)
            end.record()
            if on:
                stages, counts = profiling.stage_totals(cuda_device)
                wall = start.elapsed_time(end) * 1e6
        runs.append((state, summary))
    total = sum(v['ns'] for v in stages.values())
    assert abs(total - wall) <= 0.02 * wall, (total, wall, stages)
    for name in ('draws.actions', 'draws.step', 'dynamics', 'reset', 'merge', 'observe',
                 'summary'):
        # At the pool the reset has no work of its own: the merge kernel
        # reads the reserve itself.
        want = 0 if name == 'reset' and venv.reset_pool else steps
        assert stages[name]['marks'] == want, (name, stages)
    assert counts['layouts.used'] == int(summary['episodes']) > 0
    if venv.reset_pool:
        assert counts['layouts.made'] == steps // 16 * venv.refresh_slots(0, 16)[1]
    else:
        assert counts['layouts.made'] == 4096 * steps
    (a, sa), (b, sb) = runs
    _states_equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa), (sa, sb)
    assert 0 < profiling.timer_tick_ns(cuda_device) < 1000
