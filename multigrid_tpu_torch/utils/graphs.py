"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles its main paths once and replays the program:
``VectorEnv.step`` (multigrid_tpu/parallel/vector.py:346-347), the fused
scan of ``rollout_random`` (:531-590), the single env's ``reset`` and
``step`` (multigrid_tpu/envs/env.py:193-232) and the PPO update
(multigrid_tpu/learn/ppo.py:242, 737-765). On the card the port captures
the same paths as CUDA graphs and replays them: one graph launch takes the
place of the hundreds of kernel launches that Python issues for a step.

A :class:`Graph`:

- runs its function once on a side stream (the warm-up: the kernels'
  libraries load, constants reach the device through
  :func:`~multigrid_tpu_torch.utils.device.constant`, cuBLAS and cuDNN take
  their workspaces), then sets the device's default generator and the
  kernel wrappers' launch counts back to where they stood;
- captures it in a private memory pool. The port's randomness is keyed
  (:mod:`~multigrid_tpu_torch.utils.prng`): keys are tensors carried in the
  inputs, like any state, so a replay draws what an eager run from the
  same keys draws, and no ``torch.Generator`` is registered;
- records how far each wrapper's launch count moved during the capture
  and adds that at every replay, so the counts count the launches that
  replays make.

The captured function is the root stage ``graph`` of the stage counters
(:mod:`~multigrid_tpu_torch.utils.profiling`), its carry copy the stage
``carry``; where counting is on at the capture, the graph holds their marks,
and every cache of graphs keys on whether it is. The host's spans
``mgt.graph.warmup``, ``mgt.graph.capture``, ``mgt.graph.replay``,
``mgt.graph.load`` and ``mgt.graph.clone`` show each in a profile.

Inputs are static buffers. A caller's tensors are copied in (:func:`load`);
the outputs are the graph's own tensors, which the next replay overwrites
(:func:`clone` keeps them). A *carry* graph copies its carried outputs
back into its input buffers at its end, so a loop replays it again with
nothing between two replays.

A captured function reads nothing from the device on the host (no
``.item()``, ``int()``, ``nonzero`` or boolean-mask index) and copies no
host data to the card: the capture raises where it does. Python numbers
and slice bounds are frozen at capture, so every value that changes from
call to call lives in a device tensor, and one graph serves every call of
a signature (:func:`signature`: the shapes, dtypes and devices of the
inputs and the static values, as ``jit`` caches per static argument).

:func:`disable_graphs` runs the eager loops on the card, as
``jax.disable_jit`` does. On the CPU nothing is captured: the loops run
eagerly.

Under a process mesh whose collectives are NCCL's (the card's backend) a
graph holds them, as the JAX package's sharded programs hold theirs:
every process captures the same graph at the same call, so their
collectives match in order. The warm-up runs them once eagerly on every
process (which creates NCCL's communicator before the capture); before the
capture the processes
compare the graph's key (:func:`check_key`) and raise on a mismatch. In a
process with a process group the capture runs in thread-local mode, so
that the group's watchdog thread may query its events meanwhile. Gloo's
collectives run on the host, so a mesh over gloo runs its loops eagerly
(:attr:`~multigrid_tpu_torch.parallel.mesh.Mesh.capturable`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from collections.abc import Callable
from typing import Any

import torch

from .. import ops
from . import profiling

_local = threading.local()

_TENSOR = '<tensor>'
_STATIC = '<static>'


@contextlib.contextmanager
def disable_graphs():
    """Run the port's loops eagerly on the card inside this context: the
    eager twin that the card tests and the benchmark hold the graphs to,
    in the role of ``jax.disable_jit()``."""
    depth = getattr(_local, 'disabled', 0)
    _local.disabled = depth + 1
    try:
        yield
    finally:
        _local.disabled = depth


def graphs_on(device: torch.device | str) -> bool:
    """Whether an entry point on ``device`` replays a graph: on a CUDA
    device, outside :func:`disable_graphs` and outside the function of a
    graph being warmed up or captured (whose nested entry points run their
    eager bodies into the one graph)."""
    return (torch.device(device).type == 'cuda' and not getattr(_local, 'disabled', 0)
            and not getattr(_local, 'tracing', 0))


@contextlib.contextmanager
def _tracing():
    depth = getattr(_local, 'tracing', 0)
    _local.tracing = depth + 1
    try:
        yield
    finally:
        _local.tracing = depth


def flatten(tree) -> tuple[list[torch.Tensor], Any]:
    """The tensors of ``tree`` in order, and its structure: dicts, lists,
    tuples and dataclasses are walked, anything else is a static leaf kept
    in the structure (which is hashable where the static leaves are)."""
    leaves: list[torch.Tensor] = []
    return leaves, _walk(tree, leaves)


# Module-level recursions: a nested function that calls itself is a
# reference cycle, which would hold its tensors until the cyclic collector
# runs.
def _walk(x, leaves: list[torch.Tensor]):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, dict):
        return (dict, tuple(x), tuple(_walk(v, leaves) for v in x.values()))
    if isinstance(x, (list, tuple)):
        return (type(x), None, tuple(_walk(v, leaves) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names, tuple(_walk(getattr(x, n), leaves) for n in names))
    return (_STATIC, x, ())


def unflatten(spec, leaves: list[torch.Tensor]):
    """The tree of structure ``spec`` (from :func:`flatten`) over ``leaves``."""
    return _build(spec, iter(leaves))


def _build(s, it):
    if s == _TENSOR:
        return next(it)
    kind, names, children = s
    if kind == _STATIC:
        return names
    values = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(names, values))
    if names is None:
        return kind(values)
    return kind(**dict(zip(names, values)))


def signature(tree) -> tuple:
    """What a graph of ``tree``'s inputs is keyed by: its structure with
    the static leaves, and each tensor's shape, dtype and device."""
    leaves, spec = flatten(tree)
    return spec, tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)


def key_digest(key) -> int:
    """A 63-bit digest of a graph's key that every process of a run
    computes alike: devices by their type (each process holds its own
    card), classes by their names."""
    def norm(x):
        if isinstance(x, (tuple, list)):
            return tuple(norm(v) for v in x)
        if isinstance(x, torch.device):
            return x.type
        if isinstance(x, type):
            return f'{x.__module__}.{x.__qualname__}'
        return repr(x)
    digest = hashlib.sha256(repr(norm(key)).encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def check_key(key, group, device) -> None:
    """Raise unless every process of ``group`` is about to capture a graph
    of the same ``key`` (by :func:`key_digest`, one all-reduce on
    ``device``): their collectives must match in order. Nothing without a
    group."""
    from ..parallel import distributed

    d = key_digest(key)
    if not distributed.agree(d, group, device):
        raise RuntimeError(
            f'process {distributed.process_index()} captures a graph (key digest {d}) that '
            'another process of its group does not capture at this call')


def _copy(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    """``d.copy_(s)`` for each pair, one fused launch per dtype."""
    groups: dict[torch.dtype, tuple[list, list]] = {}
    for d, s in zip(dst, src):
        if d is not s:
            if d.shape != s.shape:
                raise ValueError(f'cannot load a {tuple(s.shape)} tensor into a '
                                 f'{tuple(d.shape)} buffer')
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def load(buffers, values) -> None:
    """Copy the tensors of ``values`` into those of ``buffers``, a tree of
    the same structure (a buffer given as its own value is left alone)."""
    with profiling.trace_annotation('mgt.graph.load'):
        dst, spec = flatten(buffers)
        src, spec_v = flatten(values)
        if spec != spec_v:
            raise ValueError('the values do not have the buffers\' structure')
        _copy(dst, src)


def clone(tree):
    """``tree`` with every tensor copied into a fresh contiguous one."""
    with profiling.trace_annotation('mgt.graph.clone'):
        leaves, spec = flatten(tree)
        out = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in leaves]
        _copy(out, leaves)
        return unflatten(spec, out)


def run_body(fn: Callable, inputs, carry: bool, device: torch.device):
    """What a :class:`Graph` captures: ``fn(inputs)`` as the root stage
    ``graph`` and, for a carry graph, the copy of the carried outputs into
    ``inputs`` as the stage ``carry``. Returns the outputs."""
    leaves, spec = flatten(inputs)
    with profiling.graph_stage(device):
        out = fn(inputs)
        if carry:
            new, out = out
            new_leaves, new_spec = flatten(new)
            if new_spec != spec:
                raise ValueError('a carry graph must return its inputs\' structure')
            with profiling.stage('carry'):
                # A carried output that is another input's buffer is read
                # before that buffer is written.
                ptrs = {x.untyped_storage().data_ptr() for x in leaves if x.numel()}
                new_leaves = [s.clone() if s is not d and s.numel()
                              and s.untyped_storage().data_ptr() in ptrs else s
                              for d, s in zip(leaves, new_leaves)]
                _copy(leaves, new_leaves)
    return out


class Graph:
    """``fn`` captured once on the static input buffers ``inputs`` (a tree
    of tensors, used as they are) and replayed by :meth:`replay`.

    ``fn(inputs)`` returns the output tree. With ``carry`` it returns
    ``(carry, out)``: ``carry`` has the structure of ``inputs`` and is
    copied into them at the end of the graph, and :meth:`replay` returns
    ``out``. ``device`` is the card's where ``inputs`` holds no tensor. ``group`` is
    the process group whose processes capture this graph together (a
    mesh's): ``key`` (by default the inputs' :func:`signature`) is checked
    over it first (:func:`check_key`).

    After the capture, :attr:`launches` holds each kernel wrapper's
    launches a replay makes (each replay adds them to the wrappers' counts,
    whose owners are resolved once, here), :attr:`warmup_s` and
    :attr:`capture_s` the host seconds of the warm-up (synchronized) and of
    the capture, and :attr:`pool_bytes` the device memory the capture
    reserved for the graph's private pool.
    """

    def __init__(self, fn: Callable, inputs, *, carry: bool = False,
                 device: torch.device | None = None, group=None, key=None):
        leaves, _ = flatten(inputs)
        device = torch.device(device if device is not None else leaves[0].device)
        # A tensor elsewhere would be read once, at the capture, and frozen.
        away = {str(x.device) for x in leaves if x.device.type != device.type}
        if away:
            raise ValueError(f'a graph on {device} takes no input on {sorted(away)}')
        self.inputs = inputs
        if group is not None:
            check_key(signature(inputs) if key is None else key, group, device)
        self._capture(fn, device, carry)

    def _capture(self, fn: Callable, device: torch.device, carry: bool) -> None:
        """The warm-up of ``fn`` on :attr:`inputs` and its capture."""
        inputs = self.inputs
        # Any draw of the warm-up from the device's default generator is
        # undone (the capture registers that generator by itself).
        index = device.index if device.index is not None else torch.cuda.current_device()
        default = torch.cuda.default_generators[index]
        rewind = default.get_state()
        counts = ops.launch_counts()
        stream = torch.cuda.current_stream(device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with profiling.trace_annotation('mgt.graph.warmup'), torch.cuda.stream(side), \
                _tracing():
            run_body(fn, inputs, False, device)
        stream.wait_stream(side)
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        default.set_state(rewind)
        ops.set_launch_counts(counts)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        # A process group's watchdog thread queries its events on the card.
        mode = 'thread_local' if torch.distributed.is_available() \
            and torch.distributed.is_initialized() else 'global'
        t0 = time.perf_counter()
        with profiling.trace_annotation('mgt.graph.capture'), torch.cuda.device(device), \
                torch.cuda.graph(self.graph, capture_error_mode=mode), _tracing():
            out = run_body(fn, inputs, carry, device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        after = ops.launch_counts()
        self.launches = {k: after[k] - counts[k] for k in counts if after[k] != counts[k]}
        self._adds = [(owner, attr, self.launches[k]) for k, owner, attr in ops.launch_owners()
                      if k in self.launches]
        ops.set_launch_counts(counts)
        self.outputs = out

    def replay(self):
        """Launch the graph on the current stream; returns its outputs (the
        graph's own tensors)."""
        with profiling.trace_annotation('mgt.graph.replay'):
            self.graph.replay()
            for owner, attr, n in self._adds:
                setattr(owner, attr, getattr(owner, attr) + n)
        return self.outputs


def call(cache: dict, key, args, fn: Callable, *,
         device: torch.device | None = None, group=None):
    """``fn(args)`` through the graph cached in ``cache`` under ``key`` and
    ``args``' :func:`signature` (captured at the first call, the key
    checked over ``group``): ``args`` is copied into the graph's buffers
    and its outputs are cloned out, so a caller that keeps an earlier
    call's results never sees them overwritten."""
    full = (key, signature(args))
    entry = cache.get(full)
    if entry is None:
        buffers = clone(args)
        entry = cache[full] = (buffers, Graph(fn, buffers, device=device, group=group,
                                              key=full))
    else:
        load(entry[0], args)
    return clone(entry[1].replay())


__all__ = ['Graph', 'call', 'check_key', 'clone', 'disable_graphs', 'flatten', 'graphs_on',
           'key_digest', 'load', 'run_body', 'signature', 'unflatten']
