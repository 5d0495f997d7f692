"""The readers of the program's stage table and replay spans, on a
synthetic trace: each stage metric reads its stages' microseconds an env
step, the layouts' share reads the two counts, the launch idle reads the
idle time inside the replays' spans, and each reads nothing where the
table or the spans are not there (a program without stage counters)."""

import pytest

from portbench import harness
from portbench.tracing import Trace

STAGE_METRICS = {
    'draws_us_per_step.env': ('draws.actions', 'draws.step'),
    'dynamics_us_per_step.env': ('dynamics',),
    'reset_us_per_step.env': ('reset', 'merge', 'pool'),
    'observe_us_per_step.env': ('observe',),
    'carry_us_per_step.env': ('summary', 'carry'),
}
NS = {'between': 7_000, 'graph': 1_000, 'draws.actions': 2_000, 'draws.step': 3_000,
      'dynamics': 11_000, 'reset': 13_000, 'merge': 17_000, 'pool': 19_000,
      'observe': 23_000, 'summary': 29_000, 'carry': 31_000}
STEPS = 4


def _ctx(stages='absent', host=()):
    trace = Trace(ops=[('k', 0, 10), ('k', 30, 40), ('k', 70, 100)], host=list(host),
                  start_us=0, window_us=100, work=STEPS)
    if stages != 'absent':
        trace.stages = stages
    cell = harness.Cell('empty16-random', {}, {'driver': 'random_rollout'}, 1, 3, 1.0, True,
                        'cpu', 0.0)
    return harness.MetricContext(cell, trace, None)


def _table(**changes):
    return {'ns': dict(NS), 'marks': dict.fromkeys(NS, STEPS),
            'counts': {'layouts.made': 4096 * STEPS, 'layouts.used': 4096}, 'steps': STEPS,
            'episodes': 4096, 'wall_ns': sum(NS.values()), 'host_s': 1.0, 'tick_ns': 32,
            **changes}


@pytest.mark.parametrize('name', list(STAGE_METRICS))
def test_stage_metric_reads_its_stages(name):
    want = sum(NS[s] for s in STAGE_METRICS[name]) / STEPS / 1e3
    assert harness.read_metric(name, _ctx(_table())) == pytest.approx(want)


def test_reset_metric_without_a_pool_reads_reset_and_merge():
    ns = {k: v for k, v in NS.items() if k != 'pool'}
    got = harness.read_metric('reset_us_per_step.env', _ctx(_table(ns=ns)))
    assert got == pytest.approx((NS['reset'] + NS['merge']) / STEPS / 1e3)


def test_layouts_share_reads_the_counts():
    assert harness.read_metric('layouts_used_share.env', _ctx(_table())) == \
        pytest.approx(100 / STEPS)
    assert harness.read_metric('layouts_used_share.env',
                               _ctx(_table(counts={'layouts.used': 3}))) is None


@pytest.mark.parametrize('name', list(STAGE_METRICS) + ['layouts_used_share.env'])
def test_stage_metrics_read_nothing_without_a_table(name):
    assert harness.read_metric(name, _ctx(None)) is None


def test_stage_table_is_not_measured_for_other_traffic():
    ctx = _ctx()
    ctx.cell.traffic['driver'] = 'ppo'
    assert harness.read_metric('dynamics_us_per_step.env', ctx) is None
    assert ctx.trace.stages is None


def test_launch_idle_reads_the_gaps_inside_replays():
    # Gaps: 10-30, 40-70. Replays 5-35 and 60-90 hold 20 + 10 us of them;
    # the other span holds none.
    host = [('mgt.graph.replay', 5, 35), ('mgt.graph.replay', 60, 90), ('aten::add', 40, 70)]
    got = harness.read_metric('launch_idle_us_per_step.env', _ctx(host=host))
    assert got == pytest.approx(30 / STEPS)


def test_launch_idle_reads_nothing_without_replay_spans():
    host = [('cudaGraphLaunch', 5, 35)]
    assert harness.read_metric('launch_idle_us_per_step.env', _ctx(host=host)) is None


@pytest.mark.parametrize('name', ['empty16-random', 'bup-random'])
def test_stage_table_of_a_tiny_run(tiny_root, name):
    """The table a traced run's readers read, measured on the CPU at the
    tiny size (the program's loops eager, its marks on the host's clock):
    every env stage closes once a step, the layouts taken are the
    summaries' episodes, the layouts made each reset's envs or each
    refresh's slots."""
    from portbench import stages
    cell, _ = harness.resolve(name, 2**31 + 5, 0.0, True, 'cpu', 0.0, root=tiny_root)
    table = stages.measure(cell)
    steps = cell.traffic['steps_per_call'] * cell.traffic['stretch_calls']
    e = cell.config['num_envs']
    assert table['steps'] == steps
    for stage in ('draws.actions', 'draws.step', 'dynamics', 'reset', 'merge', 'observe',
                  'summary'):
        assert table['marks'][stage] == steps, (stage, table)
    assert table['counts']['layouts.used'] == table['episodes'] > 0
    if cell.config['reset_pool']:
        assert table['marks']['pool'] == steps
        assert 0 < table['counts']['layouts.made'] <= e * steps
    else:
        assert table['counts']['layouts.made'] == e * steps
    assert table['wall_ns'] is None and table['host_s'] > 0
