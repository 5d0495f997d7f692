"""Records the aten operations of a function's calls, to show on the CPU
that a CUDA graph of it can be captured on the card: each call issues the
same operations with the same non-tensor arguments, reads nothing from the
device on the host and copies no host data to the device.

A ``TorchDispatchMode`` records two consecutive calls after one warm-up
call, as the capture has, with the kernels' plain versions recorded as one
opaque launch each (on the card they are one kernel). Imports no JAX: the
spawned processes of the mesh tests use it too.
"""

import dataclasses
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo, obs_cuda
from multigrid_tpu_torch.utils import prng

#: Operations that read the device on the host or copy host data to it:
#: a capture refuses them, or freezes what they read.
HOST_READS = {
    'aten._local_scalar_dense.default', 'aten.item.default', 'aten.equal.default',
    'aten.is_nonzero.default', 'aten.nonzero.default', 'aten.argwhere.default',
    'aten.masked_select.default', 'aten._unique2.default', 'aten.unique_dim.default',
    'aten.unique_consecutive.default', 'aten.bincount.default',
    'aten.repeat_interleave.Tensor', 'aten.lift_fresh.default',
    'aten.lift_fresh_copy.default',
}

#: The kernels' plain versions, which the wrappers take on the CPU: each is
#: recorded as one launch with its arguments' shapes.
KERNEL_PLAIN = [
    (obs_cuda, 'gen_obs_batched_plain'),
    (fused_linear, 'onehot_linear_plain'), (fused_linear, 'onehot_linear_agents_plain'),
    (fused_linear, 'onehot_linear_grad_w_plain'),
    (fused_linear, 'onehot_linear_agents_grad_w_plain'),
    (fused_ppo, 'ppo_mlp_grads_plain'), (fused_ppo, 'ppo_mlp_grads_agents_plain'),
    (fused_policy, 'policy_sample_plain'),
    (prng, 'draw_plain'), (prng, 'step_draws_plain'),
]



def describe(x):
    """A non-tensor argument as it is; a tensor by its shape and dtype."""
    if isinstance(x, torch.Tensor):
        return ('tensor', tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, describe(v)) for k, v in x.items())
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            describe(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, float) and x != x:
        return 'nan'
    if isinstance(x, torch.Generator):
        return ('generator', x.device)
    if isinstance(x, torch.ScriptObject):  # a process group, a collective's options
        return ('script object', str(x._type()))
    return x


class Recorder(TorchDispatchMode):
    """Records ``(op, non-tensor arguments)`` of every aten operation, and
    the operations a capture refuses."""

    def __init__(self):
        super().__init__()
        self.log, self.host_reads, self.paused = [], [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            name = str(func)
            self.log.append((name, describe(args), describe(kwargs)))
            bool_index = name.startswith(('aten.index.', 'aten.index_put')) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ()) or ())
            if name in HOST_READS or bool_index:
                self.host_reads.append(name)
        return func(*args, **kwargs)


def record(fn, calls: int = 2) -> list[Recorder]:
    """The records of ``calls`` consecutive calls of ``fn`` after one
    warm-up call, with the kernels' plain versions opaque (and put back
    after)."""
    recorder = None

    def opaque(name, plain):
        @functools.wraps(plain)
        def launch(*args, **kwargs):
            if recorder is None:
                return plain(*args, **kwargs)
            recorder.paused += 1
            try:
                out = plain(*args, **kwargs)
            finally:
                recorder.paused -= 1
            recorder.log.append(('kernel:' + name, describe(args), ()))
            return out
        return launch

    saved = [(module, name, getattr(module, name)) for module, name in KERNEL_PLAIN]
    for module, name, plain in saved:
        setattr(module, name, opaque(name, plain))
    try:
        fn()
        records = []
        for _ in range(calls):
            recorder = Recorder()
            with recorder:
                fn()
            records.append(recorder)
            recorder = None
        return records
    finally:
        for module, name, plain in saved:
            setattr(module, name, plain)


def assert_capturable(records, what):
    first, second = records
    assert first.log, what
    assert not first.host_reads and not second.host_reads, (what, first.host_reads)
    assert len(first.log) == len(second.log), (what, len(first.log), len(second.log))
    for i, (a, b) in enumerate(zip(first.log, second.log)):
        assert a == b, (what, i, a, b)


def chain(fn, carry):
    """A no-argument function that runs ``carry = fn(carry)``."""
    def call():
        nonlocal carry
        carry = fn(carry)
    return call
