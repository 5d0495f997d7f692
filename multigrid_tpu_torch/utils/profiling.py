"""Tracing hooks and a wall-clock phase timer for the training CLI.

Counterpart of ``multigrid_tpu.utils.profiling``: named trace scopes
(:func:`trace_annotation`, shown in a ``torch.profiler`` trace), a trace of
an enclosed block written for TensorBoard or Perfetto (:func:`trace_to`),
and the ``PhaseTimer``. Work on the card is asynchronous: a phase's time is
of finished work only where the caller forces completion inside it, which
the training CLI does only where the JAX CLI does (at log and checkpoint
points), so that the card stays fed between them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def trace_annotation(name: str):
    """A named profiler scope (``torch.profiler.record_function``), shown
    in a captured trace."""
    return torch.profiler.record_function(name)


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


def force_completion(tree) -> float:
    """Wait until the work behind every tensor of ``tree`` (a dict, list
    or tensor) is finished, by copying one element of each to the host.
    Returns their sum, a checksum."""
    if isinstance(tree, torch.Tensor):
        return float(tree.reshape(-1)[0]) if tree.numel() else 0.0
    leaves = tree.values() if isinstance(tree, dict) else tree
    return sum(force_completion(leaf) for leaf in leaves)


class PhaseTimer:
    """Accumulating wall-clock timer for named phases.

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
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._calls[name] += 1

    def sync(self, tree) -> None:
        force_completion(tree)

    def summary(self) -> dict:
        return {name: {'total_s': round(self._total[name], 4), 'calls': self._calls[name]}
                for name in self._total}
