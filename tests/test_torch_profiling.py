"""The port's tracing (``multigrid_tpu_torch/utils/profiling.py``) on the CPU.

Spans: their names and nesting in a ``torch.profiler`` trace of a rollout,
and no record function while no profiler runs. Stage counters: on the
CPU a mark reads the host's clock, and :class:`EagerGraph` runs what a
graph captures (``graphs.run_body``) at every replay, so the stages of a
graphed rollout are counted here as the card counts them: the stages' self
times sum to the stretch's wall, each stage closes once a step (``carry``
and ``between`` once a replay), the layouts counted are the summary's
episodes and the resets' or refreshes' layouts, and counting changes no
bit of the results. Empty-5x5 (exact reset) and BlockedUnlockPickup (the
reserve pool) at 8 envs.
"""

import json
import time

import pytest
import torch

from multigrid_tpu_torch.core.state import STATE_FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import graphs, profiling

EMPTY = 'MultiGrid-Empty-5x5-v0'
BUP = 'MultiGrid-BlockedUnlockPickup-v0'
E = 8
#: (env, max_steps, steps a rollout): exact reset, one-step graphs; the pool,
#: a chunk graph of 16 steps and two one-step replays.
CASES = {'exact': (EMPTY, 3, 8), 'pool': (BUP, 6, 18)}
ENV_STAGES = ['draws.actions', 'draws.step', 'dynamics', 'reset', 'merge', 'observe',
              'summary']


class _EagerReplay:
    def __init__(self, graph):
        self.g = graph

    def replay(self):
        g = self.g
        with graphs._tracing():
            g.outputs = graphs.run_body(g.fn, g.inputs, g.carry, g.device)


class EagerGraph(graphs.Graph):
    """A :class:`graphs.Graph` whose replay runs what the card captures
    (``graphs.run_body``: the function as the stage ``graph``, the carry
    copy as ``carry``) eagerly: the CPU has no graphs."""

    def _capture(self, fn, device, carry):
        self.fn, self.carry, self.device = fn, carry, device
        self.launches, self._adds, self.outputs = {}, [], None
        self.graph = _EagerReplay(self)


def _graphed(monkeypatch):
    """The port's loops on the CPU as the card runs them: graphs on, each
    an :class:`EagerGraph`."""
    monkeypatch.setattr(graphs, 'graphs_on',
                        lambda device: not getattr(graphs._local, 'tracing', 0))
    monkeypatch.setattr(graphs, 'Graph', EagerGraph)


@pytest.fixture
def graphed(monkeypatch):
    _graphed(monkeypatch)


def _venv(case):
    env_id, max_steps, _ = CASES[case]
    return VectorEnv(make(env_id, agents=2, max_steps=max_steps, device='cpu'), E,
                     packed_obs=True)


def _rollouts(venv, steps):
    """Two rollouts from one reset, the second counted from a zeroed table
    where counting is on: the table, the second's wall in ns, the state
    and the summary."""
    _, state = venv.reset(seed=5)
    state, _ = venv.rollout_random(state, 1, steps)
    profiling.zero_stages('cpu')
    t0 = time.perf_counter_ns()
    state, summary = venv.rollout_random(state, 2, steps)
    stages, counts = profiling.stage_totals('cpu')
    return stages, counts, time.perf_counter_ns() - t0, state, summary


@pytest.fixture(scope='module', params=list(CASES))
def counted(request):
    """Each case's graphed rollouts with counting on (one run for the
    tests that read it)."""
    case = request.param
    with pytest.MonkeyPatch.context() as mp:
        _graphed(mp)
        venv = _venv(case)
        with profiling.stage_counters():
            run = _rollouts(venv, CASES[case][2])
    return (case, venv) + run


def _spans(prof):
    """The spans of a profile: (name, start, end) in ns."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith('mgt.')]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_in_a_profile_of_rollout_random(graphed):
    venv = _venv('pool')
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, state = venv.reset(seed=1)
        venv.rollout_random(state, 2, CASES['pool'][2])
    spans = _spans(prof)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert set(by) == {'mgt.reset', 'mgt.pool.new', 'mgt.rollout', 'mgt.graph.load',
                       'mgt.graph.replay', 'mgt.graph.clone'}
    assert _inside(by['mgt.pool.new'][0], by['mgt.reset'][0])
    (rollout,) = by['mgt.rollout']
    # One replay of the chunk graph, two of the one-step graph.
    assert len(by['mgt.graph.replay']) == 3
    for name in ('mgt.graph.load', 'mgt.graph.replay', 'mgt.graph.clone'):
        assert all(_inside(s, rollout) for s in by[name]), name


def test_no_record_function_without_a_profiler(monkeypatch):
    def refused(*a, **k):
        raise AssertionError('a record function with no profiler running')
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refused)
    monkeypatch.setattr(torch.profiler, 'record_function', refused)
    assert profiling.trace_annotation('mgt.rollout') is profiling._NULL
    timer = profiling.PhaseTimer()
    with timer.phase('update'):
        pass
    assert timer.summary()['update']['calls'] == 1


def test_phase_timer_opens_a_span_of_its_name():
    timer = profiling.PhaseTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.phase('update'):
            torch.ones(4).sum()
    assert 'update' in {e.name for e in prof.events()}


def test_stage_times_sum_to_the_wall(counted):
    _, _, stages, _, wall, _, _ = counted
    total = sum(v['ns'] for v in stages.values())
    assert abs(total - wall) <= 0.05 * wall, (total, wall, stages)


def test_each_stage_closes_once_a_step(counted):
    case, _, stages, _, _, _, _ = counted
    steps = CASES[case][2]
    replays = steps if case == 'exact' else 3
    marks = {k: v['marks'] for k, v in stages.items()}
    want = dict.fromkeys(ENV_STAGES, steps)
    want.update(between=replays, carry=replays)
    if case == 'pool':
        want['pool'] = steps + 1  # and the chunk's refresh
    assert {k: marks[k] for k in want} == want
    assert stages['graph']['ns'] <= sum(v['ns'] for v in stages.values()) // 10


def test_layout_counts(counted):
    case, venv, _, counts, _, _, summary = counted
    steps = CASES[case][2]
    assert summary['episodes'] > 0
    assert counts['layouts.used'] == int(summary['episodes'])
    if case == 'exact':
        assert counts['layouts.made'] == E * steps
    else:
        # One refresh of the chunk's 16 steps, then one a step.
        assert counts['layouts.made'] == (venv.refresh_slots(0, 16)[1]
                                          + 2 * venv.refresh_slots(0, 1)[1]) == 12


def _bits(state, summary):
    out = {f: getattr(state, f) for f in STATE_FIELDS}
    out.update({f'extras.{k}': v for k, v in state.extras.items()})
    if state.pool is not None:
        out.update({f'pool.{f}': getattr(state.pool.reserve, f) for f in STATE_FIELDS},
                   pool_step=state.pool.step, pool_keys=state.pool.keys)
    out.update({f'summary.{k}': v for k, v in summary.items()})
    return out


def test_counting_changes_no_bit(graphed, counted):
    case, counted_venv, _, _, _, state, summary = counted
    venv = _venv(case)
    *_, off_state, off_summary = _rollouts(venv, CASES[case][2])
    on, off = _bits(state, summary), _bits(off_state, off_summary)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    # Whether counting is on is part of the graphs' key.
    assert [k[-1] for k in counted_venv._graphs] == [True]
    assert [k[-1] for k in venv._graphs] == [False]


def test_counting_off_marks_nothing(graphed, monkeypatch):
    def refused(*a, **k):
        raise AssertionError('a stage table with counting off')
    monkeypatch.setattr(profiling, '_Table', refused)
    monkeypatch.setattr(profiling, '_tables', {})
    venv = _venv('pool')
    _, state = venv.reset(seed=2)
    venv.rollout_random(state, 1, CASES['pool'][2])
    assert profiling.stage('reset') is profiling._NULL
    assert not profiling.counting()
    profiling.count('layouts.used', torch.ones(3))
    assert profiling._tables == {}


def test_train_cli_prints_stage_times(capsys, tmp_path):
    from multigrid_tpu_torch import train
    train.main(['--device', 'cpu', '--env', EMPTY, '--num-agents', '2', '--num-envs', '8',
                '--rollout-steps', '4', '--num-timesteps', str(8 * 2 * 4 * 3),
                '--encoder', 'mlp', '--hidden', '32', '--save-dir', str(tmp_path),
                '--save-interval', '100', '--stage-times'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith('timing:') and lines[-1].startswith('stages: ')
    ms = json.loads(lines[-1][len('stages: '):])
    assert {'rollout', 'gae', 'sgd', 'between', 'dynamics', 'observe'} <= set(ms)
    assert all(v >= 0 for v in ms.values()) and ms['rollout'] + ms['dynamics'] > 0
    assert not profiling.counting()
