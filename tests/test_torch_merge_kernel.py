"""The reset-merge kernel M1 (``ops/merge_cuda.py``, ``csrc/merge.cu``) ≡
the plain consume and merge (``VectorEnv.consume`` or the exact reset, then
``where_state``), bit for bit.

On the CPU: the field table :func:`merge_cuda.plan` and
:func:`merge_cuda.table` build (kinds, row bytes, what is written in place
and what goes to a new tensor) for an exact reset, the pool with Boxes and
families with extras, and a walk of that table on host memory that does
what the kernel does with each row, against the plain version. On the card
(marked ``cuda``, skipped without one): the kernel itself. The file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_merge_kernel.py -q
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.constants import Type
from multigrid_tpu_torch.core.state import STATE_FIELDS, ResetPool, where_state
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.ops import merge_cuda
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.parallel.vector import _from_rows, _rows
from multigrid_tpu_torch.utils import graphs, profiling

EMPTY = 'MultiGrid-Empty-16x16-v0'
BUP = 'MultiGrid-BlockedUnlockPickup-v0'
LH = 'MultiGrid-LockedHallway-2Rooms-v0'
RBD = 'MultiGrid-RedBlueDoors-8x8-v0'
E = 16


def _mask(kind, e, seed=0):
    """Done masks: none, one, ~0.2 % (at least one; three at 16 envs),
    all."""
    g = torch.Generator().manual_seed(seed)
    if kind == 'none':
        return torch.zeros(e, dtype=torch.bool)
    if kind == 'one':
        return torch.arange(e) == e // 3
    if kind == 'some':
        m = torch.zeros(e, dtype=torch.bool)
        m[torch.randperm(e, generator=g)[:max(3 if e < 64 else 1, e // 500)]] = True
        return m
    return torch.ones(e, dtype=torch.bool)


def _get(state, name):
    return state.extras[name[7:]] if name.startswith('extras.') else getattr(state, name)


def _to(state, device):
    """A copy of ``state``'s fields and extras on ``device``."""
    return state.replace(**{f: getattr(state, f).to(device) for f in STATE_FIELDS},
                         extras={k: v.to(device) for k, v in state.extras.items()})


def _pool_to(pool, device):
    return None if pool is None else ResetPool(
        _to(pool.reserve, device), pool.step.to(device),
        None if pool.keys is None else pool.keys.to(device))


def _equal(a, b):
    """Field names where two states differ (extras and, where both have
    one, the pool's tensors included)."""
    bad = [f for f in STATE_FIELDS if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]
    if a.extras.keys() != b.extras.keys():
        return bad + ['extras']
    bad += [k for k in a.extras if not torch.equal(a.extras[k].cpu(), b.extras[k].cpu())]
    if (a.pool is None) != (b.pool is None):
        return bad + ['pool']
    if a.pool is not None:
        bad += ['pool.' + f for f in _equal(a.pool.reserve, b.pool.reserve)]
        if not torch.equal(a.pool.step.cpu(), b.pool.step.cpu()):
            bad.append('pool.step')
    return bad


def _stepped(env_id, e, device, seed=3):
    """A VectorEnv, its state after a reset, and one ``step_dynamics`` of
    random actions: ``(venv, state, (obs_state, new_state, done, fresh),
    inputs)``, ``inputs`` what ``VectorEnv.step`` protects from M1: the
    input state's tensors and the step's rewards, terminations,
    truncations, ``done`` and ``success``."""
    venv = VectorEnv(make(env_id, agents=2, device=device), e)
    _, state = venv.reset(seed=seed)
    g = torch.Generator().manual_seed(seed)
    actions = torch.randint(0, 7, (e, 2), generator=g).to(device)
    obs_state, new_state, rew, term, trunc, done, success, fresh = venv.step_dynamics(
        state, actions)
    inputs = merge_cuda.state_tensors(state) + [rew, term, trunc, done, success]
    return venv, state, (obs_state, new_state, done, fresh), inputs


def _source(venv, pool, fresh):
    """What ``reset_done`` hands M1 on the card without a mesh: the packed
    reserve and its step, or the exact reset."""
    gen, rng = fresh
    if pool is None:
        return venv.env.reset_from(gen, rng), None
    return pool.reserve, pool.step


def _walk(rows, count, done, step, slots):
    """The kernel's work on host memory, row by row: a finished env's row
    of each field from its slot (or its own), unpacked where packed; a
    running env's kept row where the field has one."""
    for i, d in enumerate(done.tolist()):
        slot = i if step is None else (i + int(step) % slots) % slots
        for f in rows[:count]:
            dst = f.dst + i * f.bytes
            if d:
                src = f.src + (i if f.kind == merge_cuda.KEY else slot) * f.src_stride
                if f.kind == merge_cuda.UNPACK:
                    cells = np.ctypeslib.as_array(
                        (ctypes.c_int32 * (f.bytes // 12)).from_address(src))
                    lanes = f.shift + np.array([8, 4, 0], np.int32)
                    out = ((cells[:, None] >> lanes) & 15).astype(np.int32).reshape(-1)
                    ctypes.memmove(dst, out.ctypes.data, f.bytes)
                else:
                    ctypes.memmove(dst, src, f.bytes)
            elif f.keep:
                ctypes.memmove(dst, f.keep + i * f.keep_stride, f.bytes)


# ------------------------------------------------------------------- CPU

@pytest.fixture(scope='module')
def stepped():
    """Each family's stepped batch on the CPU, made once for the module."""
    return {env_id: _stepped(env_id, E, 'cpu') for env_id in (EMPTY, BUP, LH, RBD)}


# (name, kind, shift, in place) of each field the table holds, in order.
# The stepped agent_terminated at Empty and BUP is the step's terminations,
# which the step returns: it goes to a new tensor.
_TABLES = {
    EMPTY: [('grid', 'COPY', 0, True), ('agent_pos', 'COPY', 0, True),
            ('agent_dir', 'COPY', 0, True), ('agent_color', 'COPY', 0, False),
            ('agent_terminated', 'COPY', 0, False), ('agent_carrying', 'COPY', 0, True),
            ('agent_carrying_contents', 'COPY', 0, True), ('step_count', 'COPY', 0, True),
            ('rng', 'KEY', 0, True)],
    # Boxes: two unpacks of the one packed plane; the hook's new
    # agent_terminated is a second destination; the extras the step passed
    # through go to new tensors.
    BUP: [('grid', 'UNPACK', 0, True), ('box_contents', 'UNPACK', 12, True),
          ('agent_pos', 'COPY', 0, True), ('agent_dir', 'COPY', 0, True),
          ('agent_color', 'COPY', 0, False), ('agent_terminated', 'COPY', 0, False),
          ('agent_terminated', 'COPY', 0, True), ('agent_carrying', 'COPY', 0, True),
          ('agent_carrying_contents', 'COPY', 0, True), ('step_count', 'COPY', 0, True),
          ('rng', 'KEY', 0, True), ('extras.mission_color', 'COPY', 0, False),
          ('extras.target_enc', 'COPY', 0, False)],
    # door_unlocked: the hook's new flags in place, the observed state's
    # (the input's) to a new tensor.
    LH: [('grid', 'UNPACK', 0, True), ('agent_pos', 'COPY', 0, True),
         ('agent_dir', 'COPY', 0, True), ('agent_color', 'COPY', 0, False),
         ('agent_terminated', 'COPY', 0, True), ('agent_carrying', 'COPY', 0, True),
         ('agent_carrying_contents', 'COPY', 0, True), ('step_count', 'COPY', 0, True),
         ('rng', 'KEY', 0, True), ('extras.door_unlocked', 'COPY', 0, True),
         ('extras.door_unlocked', 'COPY', 0, False)],
}


@pytest.mark.parametrize('env_id', [EMPTY, BUP, LH])
def test_table_kinds_row_bytes_and_aliasing(stepped, env_id):
    """The table for an exact reset (Empty: no Box table, a broadcast
    grid), the pool with Boxes (BUP) and a family whose hook replaces an
    extra (LockedHallway): each destination's kind, its row bytes and
    whether it is written in place, never a tensor of the step's input
    state, of what the step returns or of the source; a destination both
    states share once."""
    venv, state, (obs_state, new_state, done, fresh), inputs = stepped[env_id]
    source, step = _source(venv, state.pool, fresh)
    fields, obs, new = merge_cuda.plan(
        done, obs_state, new_state, source, fresh[1],
        slots=None if step is None else source.grid.shape[0], packed=state.pool is not None,
        inputs=inputs)
    got = [(f.name, ['COPY', 'KEY', 'UNPACK'][f.kind], f.shift, f.keep is None) for f in fields]
    assert got == _TABLES[env_id]
    ins = {t.untyped_storage().data_ptr() for t in inputs if t.numel()}
    for f in fields:
        dst = f.dst[0]
        assert f.row_bytes == dst.numel() * dst.element_size()
        assert f.dst.is_contiguous() and f.dst.untyped_storage().data_ptr() not in ins
        given = [_get(s, f.name) for s in (new_state, obs_state)]
        assert any(f.dst is t for t in given) == (f.keep is None)
    rows, _ = merge_cuda.table(fields)
    units = {f.name: r.unit for f, r in zip(fields, rows)}
    assert units['rng'] == 16 and units['agent_terminated'] == 1
    if env_id == EMPTY:
        assert rows[0].src_stride == 0 and rows[0].bytes == 16 * 16 * 3 * 4
    if env_id == BUP:
        assert rows[0].bytes == 11 * 6 * 3 * 4 and rows[0].src_stride == 11 * 6 * 4
        assert obs.grid is new.grid and obs.agent_terminated is not new.agent_terminated
    if env_id != LH:
        # The terminations the step returns are its agent_terminated.
        term = inputs[-4]
        assert term.untyped_storage().data_ptr() == \
            new_state.agent_terminated.untyped_storage().data_ptr()


@pytest.mark.parametrize('mask', ['none', 'one', 'some', 'all'])
@pytest.mark.parametrize('env_id', [EMPTY, BUP, LH, RBD])
def test_table_walk_matches_plain(stepped, env_id, mask):
    """The table walked on host memory as the kernel walks it ≡ the plain
    consume and ``where_state``; the pool's step at 0, E − 1 and past E
    (the slots wrap around); the input state and the stepped
    ``agent_terminated`` (at Empty and BUP the terminations the step
    returns) unchanged."""
    venv, state, (obs_state, new_state, _, fresh), _ = stepped[env_id]
    done = _mask(mask, E)
    pool = state.pool
    if pool is not None:
        g = {'none': 0, 'one': E - 1, 'some': E + 5, 'all': 3 * E + 2}[mask]
        pool = ResetPool(pool.reserve, g, pool.keys)
    before = state.clone()
    want_obs, want = venv.reset_done(done, obs_state.clone(), new_state.clone(), fresh, pool,
                                     protected=[])
    obs_state, new_state = obs_state.clone(), new_state.clone()
    term = new_state.agent_terminated
    term_before = term.clone()
    source, step = _source(venv, pool, fresh)
    slots = None if step is None else source.grid.shape[0]
    fields, got_obs, got = merge_cuda.plan(done, obs_state, new_state, source, fresh[1],
                                           slots=slots, packed=pool is not None,
                                           inputs=merge_cuda.state_tensors(state) + [term])
    rows, alive = merge_cuda.table(fields)
    _walk(rows, len(fields), done, step, slots)
    assert _equal(got, want) == [] and _equal(got_obs, want_obs) == []
    assert _equal(state, before) == [] and torch.equal(term, term_before)


def test_window_source_walk_matches_plain(stepped):
    """A window of the reserve (a mesh's source: int32 rows cut back into
    strided views, read at offset 0) walked as the kernel walks it ≡ the
    plain consume at that step."""
    venv, state, (obs_state, new_state, _, fresh), _ = stepped[BUP]
    done = _mask('some', E, seed=1)
    pool = ResetPool(state.pool.reserve, E + 7, state.pool.keys)
    want_obs, want = venv.reset_done(done, obs_state.clone(), new_state.clone(), fresh, pool,
                                     protected=[])
    idx = (torch.arange(E) + pool.step) % E
    window = _from_rows(_rows(pool.reserve).index_select(0, idx), pool.reserve)
    assert window.agent_pos.stride(0) > 2  # a strided view of the rows
    fields, got_obs, got = merge_cuda.plan(
        done, obs_state.clone(), new_state.clone(), window, fresh[1], packed=True,
        inputs=merge_cuda.state_tensors(state))
    rows, alive = merge_cuda.table(fields)
    _walk(rows, len(fields), done, None, None)
    assert _equal(got, want) == [] and _equal(got_obs, want_obs) == []


@pytest.mark.parametrize('env_id', [EMPTY, BUP])
def test_step_protects_what_it_returns(monkeypatch, env_id):
    """``VectorEnv.step`` with its merge done as the kernel does it (the
    table ``reset_done`` would hand M1 on the card, walked on host memory,
    in place) ≡ the plain step, every output, across episodes that end by
    termination: what the step protects keeps the returned terminations
    (the stepped ``agent_terminated``) the ending episode's."""
    venv = VectorEnv(make(env_id, agents=2, device='cpu'), 32)
    _, state = venv.reset(seed=13)
    state, actions = _ending(state)
    want = venv.step(state, actions)

    def walked(done, obs_state, new_state, fresh, pool=None, *, protected):
        source, step = _source(venv, pool, fresh)
        slots = None if step is None else source.grid.shape[0]
        fields, obs_state, new_state = merge_cuda.plan(
            done, obs_state, new_state, source, fresh[1], slots=slots, packed=pool is not None,
            inputs=protected)
        rows, alive = merge_cuda.table(fields)
        _walk(rows, len(fields), done, step, slots)
        return obs_state, new_state
    monkeypatch.setattr(venv, 'reset_done', walked)
    got = venv.step(state, actions)
    assert bool(want[3][1::4].all()) and bool(want[5][1::4].all())
    names = ('obs', 'state', 'rewards', 'terminations', 'truncations', 'done', 'success')
    assert [n for n, a, b in zip(names, got, want) if not _same(a, b)] == []


def test_table_refuses_what_does_not_fit(stepped):
    """Extras that differ, or a source whose rows do not fit, raise."""
    venv, state, (obs_state, new_state, done, fresh), inputs = stepped[BUP]
    source = state.pool.reserve
    with pytest.raises(ValueError, match='extras differ'):
        merge_cuda.plan(done, obs_state, new_state, source.replace(extras={}), fresh[1],
                        slots=E, packed=True, inputs=inputs)
    with pytest.raises(ValueError, match='grid: fresh rows .* do not fit'):
        merge_cuda.plan(done, obs_state, new_state, source, fresh[1], slots=E + 1, packed=True,
                        inputs=inputs)
    with pytest.raises(ValueError, match='at most'):
        merge_cuda.table([None] * (merge_cuda.MAX_FIELDS + 1))


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


_CARD_CASES = [(EMPTY, m, 0) for m in ('none', 'one', 'some', 'all')] + [
    (BUP, m, g) for m, g in (('none', 0), ('one', 0), ('some', -1), ('all', -1),
                             ('some', 5), ('one', 2))] + [
    (LH, 'some', 3), (RBD, 'all', -1)]


@pytest.mark.cuda
@pytest.mark.parametrize('env_id,mask,g', _CARD_CASES)
def test_kernel_matches_plain(cuda_device, env_id, mask, g):
    """M1 (``reset_done`` on the card, one launch) ≡ the plain consume and
    ``where_state`` on the CPU copies: exact reset (Empty, no Box table),
    pool with Boxes (BUP), extras (LockedHallway, RedBlueDoors); done
    masks of none, one, ~0.2 % and all; the pool's step at 0, E − 1 and
    past E (``g`` -1: E − 1, 5 and 2: g + 5·E). The input state and the
    step's returned tensors are never written."""
    e = 2048
    venv, state, (obs_state, new_state, _, fresh), inputs = _stepped(env_id, e, cuda_device)
    done = _mask(mask, e).to(cuda_device)
    pool = state.pool
    if pool is not None:
        pool = ResetPool(pool.reserve, e - 1 if g < 0 else g + (5 * e if g else 0), pool.keys)
    cpu_venv = VectorEnv(make(env_id, agents=2, device='cpu'), e)
    cpu = [_to(s, 'cpu') for s in (obs_state, new_state)]
    want_obs, want = cpu_venv.reset_done(
        done.cpu(), cpu[0] if obs_state is not new_state else cpu[1], cpu[1],
        tuple(None if t is None else t.cpu() for t in fresh), _pool_to(pool, 'cpu'),
        protected=[])
    before = state.clone()
    returned = [t.clone() for t in inputs[-5:]]
    launches = merge_cuda.launches
    got_obs, got = venv.reset_done(done, obs_state, new_state, fresh, pool, protected=inputs)
    torch.cuda.synchronize()
    assert merge_cuda.launches == launches + 1
    assert _equal(got, want) == [] and _equal(got_obs, want_obs) == []
    assert _equal(state, before) == []
    assert all(torch.equal(a, b) for a, b in zip(inputs[-5:], returned))


@pytest.mark.cuda
def test_kernel_window_source_matches_plain(cuda_device):
    """A window of the reserve as a mesh gives it (strided views of int32
    rows, offset 0), in one process: M1 ≡ the plain consume and merge."""
    e = 1024
    venv, state, (obs_state, new_state, _, fresh), inputs = _stepped(BUP, e, cuda_device)
    done = _mask('some', e, seed=2).to(cuda_device)
    reserve = state.pool.reserve
    idx = (torch.arange(e, device=cuda_device) + 7) % e
    window = _from_rows(_rows(reserve).index_select(0, idx), reserve)
    got_obs, got = merge_cuda.reset_merge(done, obs_state, new_state, window, fresh[1],
                                          packed=True, inputs=inputs)
    want = venv.pool_unpack(window).replace(rng=fresh[1])
    assert _equal(got, where_state(done, want, new_state)) == []
    assert _equal(got_obs, where_state(done, want, obs_state)) == []


@pytest.mark.cuda
@pytest.mark.parametrize('env_id', [BUP, EMPTY])
def test_graphed_chunk_matches_cpu(cuda_device, env_id):
    """A graphed rollout of 16-step chunks on the card (the pool's chunk
    graph at BUP, one-step graphs at Empty, M1 in each step) ≡ the eager
    loop on the CPU from the same keys, across episode ends (max_steps
    20); the caller's state is never written, graphed or eager."""
    states = []
    for device in (cuda_device, 'cpu'):
        venv = VectorEnv(make(env_id, agents=2, max_steps=20, device=device), 512)
        _, state = venv.reset(seed=11)
        before = state.clone()
        out, summary = venv.rollout_random(state, 5, 48)
        assert _equal(state, before) == []
        states.append((out, summary))
    (a, sa), (b, sb) = states
    assert _equal(a, b) == []
    assert int(sa['episodes']) == int(sb['episodes']) > 0
    assert int(sa['obs_sum']) == int(sb['obs_sum'])


@pytest.mark.cuda
def test_step_leaves_the_input_and_counts_the_rows(cuda_device):
    """``VectorEnv.step`` on the card (graphed and eager) never writes the
    caller's state; under the stage counters ``layouts.used`` counts the
    rows M1 writes, the finished envs."""
    venv = VectorEnv(make(BUP, agents=2, max_steps=6, device=cuda_device), 1024)
    _, state = venv.reset(seed=4)
    actions = torch.randint(0, 7, (1024, 2), generator=torch.Generator().manual_seed(4))
    for ctx in (contextlib.nullcontext, graphs.disable_graphs):
        with ctx():
            s = state
            for _ in range(7):
                before = s.clone()
                _, s2, *_ = venv.step(s, actions)
                assert _equal(s, before) == []
                s = s2
    # A new env, whose graphs are captured with the counters on.
    venv = VectorEnv(make(BUP, agents=2, max_steps=6, device=cuda_device), 1024)
    with profiling.stage_counters():
        _, s = venv.reset(seed=4)
        s, _ = venv.rollout_random(s, 1, 16)
        profiling.zero_stages(cuda_device)
        s, summary = venv.rollout_random(s, 2, 48)
        _, counts = profiling.stage_totals(cuda_device)
    finished = int(summary['episodes'])
    assert finished > 0 and counts['layouts.used'] == finished


def _same(a, b):
    """Whether two of ``VectorEnv.step``'s outputs are equal, bit for bit
    (an observation dict, a state, or a tensor)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, 'extras'):
        return _equal(a, b) == []
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def _ending(state):
    """``state`` with episodes that end by termination this step: in every
    fourth env agent 0 faces the goal (Empty; elsewhere agent 0 is left
    where it is) and agent 1 has terminated, and in the next env both
    agents have terminated (a finished episode stepped again: its
    terminations stand). Returns ``(state, actions)``, agent 0 moving
    forward in the first group."""
    e, dev = state.agent_pos.shape[0], state.agent_pos.device
    actions = torch.randint(0, 7, (e, 2), generator=torch.Generator().manual_seed(9))
    actions[::4, 0] = 2
    first, second = torch.arange(e, device=dev) % 4 == 0, torch.arange(e, device=dev) % 4 == 1
    # The goal cell (x, y) of each env's (E, W, H) types, where it has one.
    is_goal = (state.grid[..., 0] == Type.goal.to_index()).flatten(1)
    cell, h = is_goal.int().argmax(1), state.grid.shape[2]
    facing = first & is_goal.any(1)
    pos, dirs = state.agent_pos.clone(), state.agent_dir.clone()
    pos[facing, 0] = torch.stack([cell // h - 1, cell % h], -1).to(pos.dtype)[facing]
    dirs[facing, 0] = 0  # right, onto the goal
    term = state.agent_terminated.clone()
    term[first, 1] = True
    term[second] = True
    return state.replace(agent_pos=pos, agent_dir=dirs, agent_terminated=term), actions


@pytest.mark.cuda
@pytest.mark.parametrize('env_id', [EMPTY, BUP])
def test_step_returns_the_ending_episodes(cuda_device, env_id):
    """``VectorEnv.step`` on the card (graphed and eager) ≡ the CPU's step,
    every output bit for bit, across episodes that end by termination:
    the rewards and terminations are the ending episode's, not those of
    the fresh episode M1 writes into the state (the stepped
    ``agent_terminated`` is the terminations the step returns); the
    caller's state is never written."""
    out = {}
    for device in ('cpu', cuda_device):
        venv = VectorEnv(make(env_id, agents=2, device=device), 256)
        _, state = venv.reset(seed=13)
        state, actions = _ending(state)
        out[str(device)] = venv, state, actions
    cpu_venv, cpu_state, actions = out['cpu']
    want = cpu_venv.step(cpu_state, actions)
    term, done = want[3], want[5]
    assert bool(term[1::4].all()) and bool(done[1::4].all())
    if env_id == EMPTY:  # agent 0 reached the goal
        assert bool(term[::4].all()) and bool((want[2][::4, 0] > 0).all())
    venv, state, _ = out[str(cuda_device)]
    for ctx in (contextlib.nullcontext, graphs.disable_graphs):
        with ctx():
            before = state.clone()
            got = venv.step(state, actions.to(cuda_device))
            assert _equal(state, before) == []
        names = ('obs', 'state', 'rewards', 'terminations', 'truncations', 'done', 'success')
        assert [n for n, a, b in zip(names, got, want) if not _same(a, b)] == []
