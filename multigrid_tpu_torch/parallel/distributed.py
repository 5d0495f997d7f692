"""Multi-process initialization and the collectives of a sharded run.

Counterpart of ``multigrid_tpu.parallel.distributed``. A sharded run is one
process per card (``python -m torch.distributed.run --nproc-per-node N``),
each driving its share of the env batch; :func:`initialize` joins them into
a ``torch.distributed`` process group, NCCL on the card and gloo on the
CPU, after which :func:`~multigrid_tpu_torch.parallel.mesh.make_mesh` spans
every process and the same ``VectorEnv`` and PPO code runs on each. On
an update's hot path the collectives are the learner's gradient
all-reduce and, with the reserve pool, the exchange of its rows between
the env shards at every step.

The collectives the port needs live here: a sum (or max) all-reduce, an
all-gather of env rows, a shift of rows between two fixed peers (the
sharded reserve pool's exchange) and a barrier. Gloo reduces CUDA tensors but
gathers only host tensors, so under gloo, and only there, the gather of
CUDA tensors goes through host memory (two gloo processes may share one
card, which NCCL refuses). Under NCCL nothing goes through the host: every
collective is a kernel on the card, which a CUDA graph holds
(:func:`capturable`), so a sharded loop replays graphs under NCCL and runs
eagerly under gloo.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

#: How long a collective or the rendezvous waits for the other processes.
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> None:
    """Join this process to the run's process group. A no-op for one
    process: ``num_processes`` of 1, or no arguments and no launcher's
    environment.

    With no arguments it reads the launcher's environment (``torchrun``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), as
    ``jax.distributed.initialize`` reads the cluster's. Otherwise
    ``coordinator_address`` is an init method (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` is TCP). The process takes card
    ``LOCAL_RANK % device_count`` (``LOCAL_RANK`` defaults to the rank), so
    processes may share a card. ``backend`` defaults to NCCL on the card and
    gloo on the CPU (``device='cpu'``); a failed NCCL initialization raises.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        raise RuntimeError('torch.distributed is already initialized')
    if coordinator_address is None and num_processes is None and process_id is None:
        if 'WORLD_SIZE' not in os.environ:
            return
        init_method, rank = 'env://', int(os.environ['RANK'])
        world = int(os.environ['WORLD_SIZE'])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError('pass coordinator_address, num_processes and process_id '
                             'together, or none of them')
        init_method = (coordinator_address if '://' in coordinator_address
                       else f'tcp://{coordinator_address}')
        rank, world = process_id, num_processes
    join(init_method, world, rank, backend=backend, device=device, timeout=timeout)


def join(init_method: str, world: int, rank: int, *, backend: str | None = None,
         device: str | torch.device | None = None,
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join process ``rank`` of a group of ``world`` at ``init_method``, by
    :func:`initialize`'s card and backend rules, a world of one included:
    its collectives are then real calls over one process (on one card, the
    only NCCL group there can be)."""
    if dist.is_initialized():
        raise RuntimeError('torch.distributed is already initialized')
    device = resolve_device(device)
    if device.type == 'cuda':
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=timeout)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_env_batch(per_chip_envs: int) -> int:
    """Total env batch across all processes (one card each)."""
    return per_chip_envs * process_count()


def process_summary(device: str | torch.device | None = None) -> dict:
    """Topology info for logs and metrics, with the JAX package's keys.
    Every process drives one device."""
    device = resolve_device(device)
    return {
        'process_index': process_index(),
        'process_count': process_count(),
        'local_devices': 1,
        'global_devices': process_count(),
        'device_kind': (torch.cuda.get_device_name(device) if device.type == 'cuda'
                        else 'cpu'),
    }


def capturable(group) -> bool:
    """Whether a CUDA graph can hold ``group``'s collectives: true for None
    (one process: no collective) and for an NCCL group, whose collectives
    are kernels on the card; false for gloo, whose collectives run on the
    host."""
    return group is None or dist.get_backend(group) == 'nccl'


def agree(value: int, group, device) -> bool:
    """Whether every process of ``group`` passes the same 63-bit ``value``
    (one max all-reduce of it and its negation on ``device``, read on the
    host); true without a group."""
    if group is None:
        return True
    top = all_reduce(torch.tensor([value, -value], device=device), group, op='max')
    return top.tolist() == [value, -value]


def all_reduce(x: torch.Tensor, group, op: str = 'sum') -> torch.Tensor:
    """The elementwise sum (or ``op='max'``) of ``x`` over ``group``'s
    processes, as a new tensor; ``x`` itself when ``group`` is None (one
    process)."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == 'sum' else dist.ReduceOp.MAX,
                    group=group)
    return out


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every process's ``x`` (all of one shape) concatenated along ``dim``
    in rank order, on ``x``'s device; ``x`` itself when ``group`` is None.
    The parts are gathered into one buffer and permuted to ``dim`` on the
    device, so nothing is read on the host and a graph holds the gather.
    Under gloo, which gathers host tensors only, a CUDA tensor goes through
    host memory."""
    if group is None:
        return x
    src = x.contiguous()
    if src.is_cuda and not capturable(group):
        src = src.cpu()
    world = dist.get_world_size(group)
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    shape = list(src.shape)
    shape[dim] *= world
    return out.view((world,) + tuple(src.shape)).movedim(0, dim).reshape(shape).to(x.device)


def shift_rows(x: torch.Tensor, group, src: int, dst: int) -> torch.Tensor:
    """The rows ``x`` of the process of rank ``src`` in ``group``, this
    process's sent to rank ``dst`` in exchange: one all-to-all with fixed
    split sizes, every process sending its rows (all of one shape) to one
    peer, so that a graph holds it under NCCL; under gloo a CUDA tensor
    goes through host memory. ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    src_rows = x.contiguous()
    if src_rows.is_cuda and not capturable(group):
        src_rows = src_rows.cpu()
    n, world = src_rows.shape[0], dist.get_world_size(group)
    out = torch.empty_like(src_rows)
    dist.all_to_all_single(out, src_rows, [n if r == src else 0 for r in range(world)],
                           [n if r == dst else 0 for r in range(world)], group=group)
    return out.to(x.device)


def barrier(group) -> None:
    """Wait for every process of ``group`` (none when it is None)."""
    if group is not None:
        dist.barrier(group=group)


__all__ = ['agree', 'all_gather_rows', 'all_reduce', 'barrier', 'capturable',
           'global_env_batch', 'initialize', 'join', 'process_count', 'process_index',
           'process_summary', 'shift_rows', 'shutdown']
