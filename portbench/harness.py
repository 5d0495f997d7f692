"""One run of one cell: the cell, its configuration and traffic found by
name, the chip checked, the cell's driver run, its metrics read, and the
result printed as the last line of standard output.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:

- ``portbench/configs/<config>.json`` (the path in the config's ``file``):
  the deployment (env, agents, envs, view, the net a learner would train);
- ``portbench/traffic/<traffic>.json``: the driver that generates the
  traffic (``portbench/drivers/<driver>.py``) and its parameters;
- ``portbench/metrics/<metric>.py``: a reader, ``read(ctx)``, of one
  per-layer metric from the traced stretch (None where it finds nothing).

A driver's ``run(cell)`` sets the program up, warms up every shape the
cell uses, measures for ``cell.seconds``, profiles a fixed stretch where
``cell.trace``, and compares what the timed path produced with the plain
reference (:mod:`portbench.reference`) once the window has closed. It
returns an :class:`Outcome`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
#: Top-level module names that no process of the benchmark may load.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'multigrid_tpu')
GIB = 2**30


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str
    #: ``time.perf_counter()`` at the process's start.
    t_start: float


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct where ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    #: The cell's end-to-end values by metric name (``setup_s`` among them).
    metrics: dict
    checks: list
    memory_peak_bytes: int
    #: The profiled stretch (:class:`portbench.tracing.Trace`) where traced.
    trace: object = None
    #: The cell's shapes (:class:`portbench.counting.Shapes`) for the readers.
    shapes: object = None


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader reads."""
    cell: Cell
    trace: object
    shapes: object


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def resolve(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
            root: Path = ROOT) -> tuple[Cell, dict]:
    """The cell ``name`` of the benchmark at ``root``, and the benchmark."""
    bench = load_benchmark(root)
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'no workload named {name!r} in BENCHMARK.json')
    w = cells[name]
    config = next(c for c in bench['configs'] if c['name'] == w['config'])
    cfg = json.loads((root / config['file']).read_text())
    traffic = json.loads((root / 'portbench' / 'traffic' / f'{w["traffic"]}.json').read_text())
    return Cell(name, cfg, traffic, w['chips'], seed, seconds, trace, device, t_start), bench


def reported(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or,
    traced, the per-layer metrics that list it (or, without a list, that
    move an end-to-end metric it reports)."""
    e2e = [m for m in bench['end_to_end'] if cell in m.get('workloads', [cell])]
    if not trace:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell in m.get('workloads', ()) or ('workloads' not in m and m['moves'] in names)]


def read_metric(name: str, ctx: MetricContext, root: Path = ROOT):
    """The value of per-layer metric ``name`` by its reader's file."""
    path = root / 'portbench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'portbench_metric_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def run_cell(cell: Cell, bench: dict, root: Path = ROOT) -> dict:
    """Run ``cell`` and return its result object (without printing)."""
    driver = importlib.import_module(f'portbench.drivers.{cell.traffic["driver"]}')
    out: Outcome = driver.run(cell)
    metrics = {}
    ctx = MetricContext(cell, out.trace, out.shapes)
    for m in reported(bench, cell.name, cell.trace):
        value = out.metrics.get(m['name']) if not cell.trace else read_metric(m['name'], ctx, root)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    device = device_info(cell, out)
    result = {'correct': all(c.ok for c in out.checks), 'attempted': out.attempted,
              'failed': out.failed, 'metrics': metrics, 'device': device}
    if out.trace is not None:
        result['breakdown'] = out.trace.breakdown()
    result['checks'] = {c.name: {'value': c.value, 'limit': c.limit} for c in out.checks}
    return result


def device_info(cell: Cell, out: Outcome) -> dict:
    import torch
    if cell.device == 'cpu':
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 0, 'memory_peak_bytes': 0}
    else:
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': cell.chips,
                'memory_peak_bytes': out.memory_peak_bytes}
    if out.trace is not None:
        info['busy_s'] = out.trace.busy_us() / 1e6
        info['window_s'] = out.trace.window_us / 1e6
    return info


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process has loaded, compared
    by whole top-level names."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: list[str], t_start: float) -> int:
    p = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json on the card.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, bench = resolve(args.workload, args.seed, args.seconds, bool(args.trace), 'cuda',
                          t_start)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 3
    result = run_cell(cell, bench)
    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {", ".join(found)}', file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]} (limit {c["limit"]})', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
