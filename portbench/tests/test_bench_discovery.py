"""A configuration, a traffic mix and a per-layer metric added as files
and entries of their own are found by name, with no other file edited."""

import json

from portbench import harness
from portbench.tracing import Trace


def test_new_files_are_found_by_name(tiny_root):
    bench = json.loads((tiny_root / 'BENCHMARK.json').read_text())
    pb = tiny_root / 'portbench'
    edited = {p: p.read_bytes() for p in pb.rglob('*') if p.is_file()}

    config = json.loads((pb / 'configs' / 'empty16x16-n4-e4096.json').read_text())
    (pb / 'configs' / 'empty16x16-n2-e8.json').write_text(json.dumps({**config, 'agents': 2}))
    (pb / 'traffic' / 'random4.json').write_text(json.dumps(
        {'driver': 'random_rollout', 'steps_per_call': 4, 'stretch_calls': 1}))
    (pb / 'metrics' / 'ops_per_stretch.env.py').write_text(
        'def read(ctx):\n    return len(ctx.trace.ops)\n')
    bench['configs'].append({'name': 'empty16x16-n2-e8', 'source': 'https://example.org',
                             'file': 'portbench/configs/empty16x16-n2-e8.json',
                             'reduced': [], 'why': 'two agents'})
    bench['workloads'].append({'name': 'empty16-random4', 'config': 'empty16x16-n2-e8',
                               'traffic': 'random4', 'chips': 1, 'why': 'short calls'})
    bench['end_to_end'][1]['workloads'].append('empty16-random4')
    bench['per_layer'].append({'name': 'ops_per_stretch.env', 'unit': 'ops', 'better': 'lower',
                               'source': 'device_trace', 'layer': 'Device',
                               'moves': 'env_agent_steps_per_s',
                               'workloads': ['empty16-random4']})
    (tiny_root / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell, bench = harness.resolve('empty16-random4', 3, 0.5, False, 'cpu', 0.0, root=tiny_root)
    assert cell.config['agents'] == 2 and cell.traffic['steps_per_call'] == 4
    result = harness.run_cell(cell, bench, root=tiny_root)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'setup_s', 'env_agent_steps_per_s', 'peak_mem_gib'}

    traced = harness.reported(bench, 'empty16-random4', trace=True)
    assert [m['name'] for m in traced] == ['ops_per_stretch.env']
    trace = Trace(ops=[('k', 0, 1)] * 3, host=[], start_us=0, window_us=2, work=1)
    ctx = harness.MetricContext(cell, trace, None)
    assert harness.read_metric('ops_per_stretch.env', ctx, root=tiny_root) == 3
    assert all(p.read_bytes() == b for p, b in edited.items())


def test_every_cell_reports_its_metrics():
    bench = harness.load_benchmark()
    names = {m['name'] for m in bench['end_to_end']}
    for w in bench['workloads']:
        e2e = {m['name'] for m in harness.reported(bench, w['name'], trace=False)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        traced = harness.reported(bench, w['name'], trace=True)
        assert traced and all(m['moves'] in e2e for m in traced)
    for m in bench['per_layer']:
        assert m['moves'] in names
        assert (harness.PACKAGE / 'metrics' / f'{m["name"]}.py').exists()
