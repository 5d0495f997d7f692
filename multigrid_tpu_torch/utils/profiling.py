"""Tracing: host spans on the profiler's clock, stage counters on the
device, and a wall-clock phase timer for the training CLI.

Counterpart of ``multigrid_tpu.utils.profiling``: named trace scopes
(:func:`trace_annotation`), a trace of an enclosed block written for
TensorBoard or Perfetto (:func:`trace_to`), and the ``PhaseTimer``. Work on
the card is asynchronous: a phase's time is of finished work only where the
caller forces completion inside it, which the training CLI does only where
the JAX CLI does (at log and checkpoint points), so that the card stays fed
between them.

**Spans.** :func:`trace_annotation` opens a range that a running
``torch.profiler`` records on the host's timeline, the clock of its CUPTI
device timeline, so that a profile puts each idle stretch of the card beside
the program's stage on the host. With no profiler running it costs one flag
check. A span is an operator-scope record function, not a user annotation,
so the profiler adds nothing of it to the device's timeline. The port opens
``mgt.rollout`` (``VectorEnv.rollout_random``), ``mgt.reset``
(``VectorEnv.reset``), ``mgt.pool.new`` (``VectorEnv.new_pool``),
``mgt.graph.load``, ``mgt.graph.replay``, ``mgt.graph.clone``,
``mgt.graph.warmup`` and ``mgt.graph.capture`` (:mod:`.graphs`),
``mgt.update`` (``TrainStep.run``), ``mgt.checkpoint.save``
(``save_checkpoint``) and each ``PhaseTimer`` phase under its own name.

**Stage counters.** Inside a captured CUDA graph all work replays as one
launch, so no host span can say which stage of the step the card spends its
time in. Under :func:`stage_counters` the port marks its stages on the
device instead: ``with stage(name):`` around a stage's work, and
:func:`count` for integers the stages produce. A mark is one launch of
``csrc/stages.cu``'s one-thread kernel: it reads the device's nanosecond
clock and adds the time since the previous mark to the stage that the work
in between belongs to, so each stage's time is its self time, and the
stages' times sum to the wall of the counted stretch. Marks are placed
where the work's stage changes: at the first operation of a stage on the
device (the port's operations run through PyTorch's dispatcher, which a
dispatch mode watches while counting is on), so a stage that follows
another directly shares its mark, and an empty stage takes none. A
captured function is the root stage ``graph``; its first mark closes
``between`` (the time since the previous replay's last mark: the host's
launch and any eager work between replays) and its last mark closes its
last stage. The table lives on the device and is read once, on request
(:func:`stage_totals`; :func:`zero_stages` clears it). On the CPU, where
the loops run eagerly, a mark reads the host's clock
(``time.perf_counter_ns``).

Whether counting is on is fixed when a graph is captured and is part of
every graph cache's key, so turning it on captures new graphs. Off, a stage
is a shared null context and a count returns at once: no mark is captured
or launched, and ``stages.cu`` is never built or loaded. Marks write only
their table: the program's results are the same bits either way.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: A table's slots: slot 0 holds the time of the last mark, the others a
#: stage's (nanoseconds, marks) or a count's (total, 0).
SLOTS = 64
#: The stage of the work outside every captured function and named stage.
ROOT = 'between'

_NULL = contextlib.nullcontext()


def trace_annotation(name: str):
    """A named span on the host's timeline of a running ``torch.profiler``
    (an operator-scope record function); a shared null context when no
    profiler runs."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace the enclosed block (the host's operators, and the card's
    kernels where there is one) into ``log_dir``, as TensorBoard's trace
    handler writes it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


# ------------------------------------------------------------ stage counters

_on = 0
#: The open stages, innermost last.
_stack = [ROOT]
#: Slot and kind ('stage' or 'count') of every name used, in first use.
_slots: dict[str, tuple[int, str]] = {}
_tables: dict[torch.device, '_Table'] = {}
#: Set while the counters run operations of their own.
_busy = False
_fns: dict = {}


def _lib(name: str):
    if name not in _fns:
        import ctypes

        from . import build
        fn = getattr(build.load('stages.cu'), name)
        if name == 'mgt_stage_mark':
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _slot(name: str, kind: str) -> int:
    entry = _slots.get(name)
    if entry is None:
        if len(_slots) + 1 >= SLOTS:
            raise RuntimeError(f'more than {SLOTS - 1} stage and count names')
        entry = _slots[name] = (len(_slots) + 1, kind)
    elif entry[1] != kind:
        raise ValueError(f'{name!r} is a {entry[1]}, not a {kind}')
    return entry[0]


class _Table:
    """One device's table, and the stage its work since the last mark
    belongs to (``owner``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = device.type == 'cuda'
        if self.card:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError('stage counters: a first mark on the card inside a '
                                   'capture (a graph warms up before it captures)')
            self.values = torch.zeros((SLOTS, 2), dtype=torch.int64, device=device)
        else:
            self.values = [[0, 0] for _ in range(SLOTS)]
        self.reset()

    def reset(self) -> None:
        #: Counts waiting for the card's next mark: (slot, tensor or None, int).
        self.pending: list = []
        self.owner, self.dirty = _stack[-1], False
        if self.card:
            self._launch(0, 0, 0, None, 0, reset=1)
        else:
            self.values = [[0, 0] for _ in range(SLOTS)]
            self.prev = time.perf_counter_ns()

    def mark(self, stage: str, counted: bool = True) -> None:
        """Close ``stage``: the time since the last mark is its."""
        close = _slot(stage, 'stage')
        if not self.card:
            now = time.perf_counter_ns()
            self.values[close][0] += now - self.prev
            self.values[close][1] += counted
            self.prev = now
            return
        pending, self.pending = self.pending, []
        slot, value, add = pending.pop(0) if pending else (0, None, 0)
        self._launch(close, int(counted), slot, value, add)
        for slot, value, add in pending:
            self._launch(0, 0, slot, value, add)

    def add(self, slot: int, value, add: int) -> None:
        if self.card:
            self.pending.append((slot, value, add))
        else:
            self.values[slot][0] += add + (int(value) if value is not None else 0)

    def _launch(self, close, counted, slot, value, add, reset=0) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            err = _lib('mgt_stage_mark')(
                self.values.data_ptr(), SLOTS, close, counted, slot,
                None if value is None else value.data_ptr(), add, reset,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f'stage mark kernel launch failed: CUDA error {err}')

    def read(self) -> list[list[int]]:
        return self.values.tolist() if self.card else [list(v) for v in self.values]


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def _table(device: torch.device) -> _Table:
    device = _norm(device)
    table = _tables.get(device)
    if table is None:
        table = _tables[device] = _Table(device)
    return table


def _device_of(args, kwargs) -> torch.device | None:
    found = None
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor):
                if t.device.type == 'cuda':
                    return t.device
                found = t.device
    dev = (kwargs or {}).get('device')
    return found if dev is None else torch.device(dev)


def _touch(device: torch.device) -> None:
    """Work for the innermost open stage is about to be issued on
    ``device``: close the previous stage there first, if it issued work
    since the last mark (otherwise the stage changes hands unmarked). The
    watcher calls it, and is off for the operations it runs."""
    table = _table(device)
    top = _stack[-1]
    if table.owner != top:
        if table.dirty:
            table.mark(table.owner)
        table.owner = top
    table.dirty = True


def _watcher():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Watcher(TorchDispatchMode):
        """Marks a stage change before the first operation of the new
        stage on each device."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not _busy:
                device = _device_of(args, kwargs)
                if device is not None:
                    _touch(device)
            return func(*args, **(kwargs or {}))

    return Watcher()


def counting() -> bool:
    """Whether stage counting is on (inside :func:`stage_counters`)."""
    return _on > 0


@contextlib.contextmanager
def stage_counters():
    """Count stages inside this context: graphs captured here hold marks
    (a new capture for each graph cache, whose keys hold this flag)."""
    global _on
    watcher = contextlib.nullcontext() if _on else _watcher()
    _on += 1
    try:
        with watcher:
            yield
    finally:
        _on -= 1


@contextlib.contextmanager
def _quiet():
    """The counters' own operations, which the watcher lets pass."""
    global _busy
    _busy = True
    try:
        yield
    finally:
        _busy = False


class _Stage:
    __slots__ = ('name',)

    def __init__(self, name: str):
        _slot(name, 'stage')
        self.name = name

    def __enter__(self):
        _stack.append(self.name)

    def __exit__(self, *exc):
        _stack.pop()


def stage(name: str):
    """A context around one stage's work on the device; a shared null
    context while counting is off."""
    return _Stage(name) if _on else _NULL


def count(name: str, value, device=None) -> None:
    """Add ``value`` to the count ``name``: an int (on ``device``), or the
    sum of a tensor's elements, added on its device at the next mark.
    Nothing while counting is off."""
    if not _on:
        return
    slot = _slot(name, 'count')
    if isinstance(value, torch.Tensor):
        # The sum is the current stage's work.
        device, value, add = value.device, value.sum(dtype=torch.int64), 0
    else:
        value, add = None, int(value)
    with _quiet():
        _table(device).add(slot, value, add)


@contextlib.contextmanager
def graph_stage(device):
    """The root stage ``graph`` of a captured function on ``device``: a
    mark at its start closes ``between`` and one at its end closes the
    stage its last work belongs to, whatever the host ran before or after,
    so that each replay accounts for its own time. Nothing while counting
    is off."""
    if not _on:
        yield
        return
    with _quiet():
        _slot('graph', 'stage')
        table = _table(device)
        table.mark(ROOT)
        table.owner, table.dirty = 'graph', False
    _stack.append('graph')
    try:
        yield
    finally:
        _stack.pop()
        with _quiet():
            table.mark(table.owner)
            table.owner, table.dirty = ROOT, False


def _pick(device) -> list[_Table]:
    if device is not None:
        table = _tables.get(_norm(device))
        return [table] if table is not None else []
    cards = [t for t in _tables.values() if t.card]
    return cards[:1] or list(_tables.values())[:1]


def zero_stages(device=None) -> None:
    """Clear the stage table of ``device`` (made here if there is none;
    by default every table); the next stretch counts from here."""
    with _quiet():
        if device is not None and _norm(device) not in _tables:
            _table(device)
        for table in (_pick(device) if device is not None else _tables.values()):
            table.reset()


def stage_totals(device=None) -> tuple[dict, dict]:
    """``({stage: {'ns', 'marks'}}, {count: n})`` since the last
    :func:`zero_stages`, from the table of ``device`` (by default the
    card's, else the CPU's). A last mark, not counted, closes the stage
    that holds the time since the previous one, so the stages' times sum to
    the wall since the zeroing. Reading the card's table waits for it."""
    tables = _pick(device)
    if not tables:
        return {}, {}
    table = tables[0]
    with _quiet():
        table.mark(table.owner, counted=False)
        table.owner, table.dirty = _stack[-1], False
        values = table.read()
    stages = {n: {'ns': values[s][0], 'marks': values[s][1]}
              for n, (s, kind) in _slots.items() if kind == 'stage'}
    counts = {n: values[s][0] for n, (s, kind) in _slots.items() if kind == 'count'}
    return stages, counts


def timer_tick_ns(device=None) -> int:
    """The smallest step of the card's nanosecond clock (``%globaltimer``)
    that a mark reads, over 64 changes of it."""
    device = torch.device(device if device is not None else 'cuda')
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib('mgt_stage_tick')(out.data_ptr(), 64,
                                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'clock tick kernel launch failed: CUDA error {err}')
    return int(out)


# ---------------------------------------------------------------- phase timer

def force_completion(tree) -> float:
    """Wait until the work behind every tensor of ``tree`` (a dict, list
    or tensor) is finished, by copying one element of each to the host.
    Returns their sum, a checksum."""
    if isinstance(tree, torch.Tensor):
        return float(tree.reshape(-1)[0]) if tree.numel() else 0.0
    leaves = tree.values() if isinstance(tree, dict) else tree
    return sum(force_completion(leaf) for leaf in leaves)


class PhaseTimer:
    """Accumulating wall-clock timer for named phases; each phase is also
    a span of its name (:func:`trace_annotation`).

    >>> timer = PhaseTimer()
    >>> with timer.phase('update'):
    ...     state, metrics = train_step(state)
    ...     timer.sync(metrics)
    >>> timer.summary()  # {'update': {'total_s': ..., 'calls': ...}}
    """

    def __init__(self):
        self._total = defaultdict(float)
        self._calls = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with trace_annotation(name):
                yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._calls[name] += 1

    def sync(self, tree) -> None:
        force_completion(tree)

    def summary(self) -> dict:
        return {name: {'total_s': round(self._total[name], 4), 'calls': self._calls[name]}
                for name in self._total}
