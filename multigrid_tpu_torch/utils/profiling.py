"""A wall-clock phase timer for the training CLI.

Counterpart of ``multigrid_tpu.utils.profiling``'s ``PhaseTimer`` and
``force_completion``. Work on the card is asynchronous: a phase's time is
of finished work only where the caller forces completion inside it, which
the training CLI does only where the JAX CLI does (at log and checkpoint
points), so that the card stays fed between them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
