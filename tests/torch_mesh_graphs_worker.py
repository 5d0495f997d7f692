"""The work of tests/test_torch_mesh_graphs.py's two spawned gloo processes.
Imports no JAX: the spawned processes start from a fresh interpreter and
load only the port."""

import torch
import torch.distributed as dist

from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, linear_schedule, make_train_step, ppo_init
from multigrid_tpu_torch.parallel import VectorEnv, distributed, make_mesh
from multigrid_tpu_torch.parallel.mesh import Mesh
from multigrid_tpu_torch.utils import graphs, prng

from . import torch_capture

BUP = 'MultiGrid-BlockedUnlockPickup-v0'

#: Sharded update bodies (2 processes, 8 global envs, mlp 32 in float32, T
#: 4, 2 epochs x 2 minibatches, the rate annealed): the env axis split
#: (advantage moments, gradient means, the batch's gather, episode sums),
#: per agent, and the model axis (the Dense_0 columns gathered).
UPDATES = {
    'env-axis': dict(shape=(2, 1)),
    'env-axis-per-agent': dict(shape=(2, 1), config=dict(per_agent_policies=True)),
    'model-axis': dict(shape=(1, 2)),
}


def _report(records) -> dict:
    """What a capture needs of two recorded calls: no host read, the same
    operations, and the collectives among them."""
    first, second = records
    return {'host_reads': first.host_reads + second.host_reads,
            'same': first.log == second.log, 'ops': len(first.log),
            'collectives': sorted({op for op, *_ in first.log if op.startswith('c10d.')})}


def update_report(shape, config=None) -> dict:
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, max_steps=3, device='cpu'), 8,
                     packed_obs=True, mesh=make_mesh(*shape))
    cfg = PPOConfig(rollout_steps=4, epochs=2, minibatches=2, **(config or {}))
    state, net, cfg, tx = ppo_init(venv, 0, config=cfg, hidden=32, dtype=torch.float32,
                                   net_kwargs=dict(encoder='mlp'),
                                   lr_schedule=linear_schedule(3e-4, 0.0, 8))
    step = make_train_step(venv, net, cfg, tx)
    return _report(torch_capture.record(torch_capture.chain(lambda s: step.update(s)[0],
                                                            state)))


def rollout_report() -> dict:
    """BUP on the replicated reserve pool, 16 global envs: the chunk graph's
    body (16 steps with ``refresh=False``, then the refresh)."""
    venv = VectorEnv(make(BUP, agents=2, max_steps=6, device='cpu'), 16,
                     reset_pool_period=4, mesh=make_mesh())
    _, state = venv.reset(seed=1)
    zero = torch.zeros((), dtype=torch.int64)
    carry = state, prng.key(2), (torch.zeros(()), zero, zero.clone())
    body = torch_capture.chain(
        lambda c: venv._random_steps(c, venv.REFRESH_CHUNK, refresh=False), carry)
    return _report(torch_capture.record(body))


def gathers() -> dict:
    """The one-buffer gather against gloo's list gather and ``torch.cat``,
    along each dim, for each dtype the port gathers: equal bit for bit."""
    rank, world = distributed.process_index(), dist.group.WORLD
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8, torch.bool):
        x = (torch.arange(3 * 4 * 5 * 2).reshape(3, 4, 5, 2) * (rank + 3)) % 251
        x = x.to(dtype)
        for dim in range(x.dim()):
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x, group=world)
            want = torch.cat(parts, dim=dim)
            got = distributed.all_gather_rows(x, world, dim=dim)
            out[f'{dtype} dim {dim}'] = (got.shape == want.shape and got.dtype == want.dtype
                                         and torch.equal(got, want))
    # A strided part (a column slice) gathers as its contiguous copy.
    y = (torch.arange(24.).reshape(4, 6) + rank)[:, 1::2]
    out['strided'] = torch.equal(distributed.all_gather_rows(y, world, dim=1),
                                 torch.cat([y - rank, y - rank + 1], dim=1))
    return out


def key_checks() -> dict:
    """The mesh-key check: equal keys pass (devices by their type, so
    ``cuda:0`` and ``cuda:1`` are one key); a key that differs by process
    raises on every process."""
    rank, world = distributed.process_index(), dist.group.WORLD
    graphs.check_key(('update', ((4, 2), torch.float32, torch.device('cuda', rank))), world,
                     'cpu')
    try:
        graphs.check_key(('step', rank), world, 'cpu')
        mismatch = None
    except RuntimeError as exc:
        mismatch = str(exc)
    return {'mismatch': mismatch}


class EagerGraph(graphs.Graph):
    """A ``Graph`` as the card makes it up to its capture (its key checked
    over its group by ``check_key``), whose capture only records the key's
    digest and whose replay runs its function eagerly: the CPU has no
    graphs."""

    digests: list = []

    def __init__(self, fn, inputs, *, key=None, **kw):
        super().__init__(fn, inputs, key=key, **kw)
        self.digests.append(graphs.key_digest(graphs.signature(inputs) if key is None
                                              else key))

    def _capture(self, fn, device, carry):
        self.fn, self.carry = fn, carry

    def replay(self):
        with graphs._tracing():
            out = self.fn(self.inputs)
        if self.carry:
            new, out = out
            graphs.load(self.inputs, graphs.clone(new))
        return out


def real_keys() -> dict:
    """The keys the sharded loops' graphs are checked by, as the card's
    processes make them, compared over this gloo group: with graphs on and
    the mesh taken as capturable, ``TrainStep.run`` (the flagship's update,
    2 updates), ``rollout_random`` (BUP on the replicated pool: its chunk
    and one-step graphs) and ``VectorEnv.step`` each build their
    :class:`EagerGraph`. Returns the digests in the order the graphs were
    made."""
    on, capturable, graph = graphs.graphs_on, Mesh.capturable, graphs.Graph
    graphs.graphs_on = lambda device: on('cuda')
    Mesh.capturable = property(lambda self: True)
    graphs.Graph = EagerGraph
    EagerGraph.digests = []
    try:
        venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, max_steps=3, device='cpu'),
                         8, packed_obs=True, mesh=make_mesh())
        state, net, cfg, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=4), hidden=32,
                                       dtype=torch.float32, net_kwargs=dict(encoder='mlp'))
        assert venv.graphed()
        make_train_step(venv, net, cfg, tx).run(state, 2)
        pool = VectorEnv(make(BUP, agents=2, max_steps=6, device='cpu'), 16,
                         reset_pool_period=4, mesh=make_mesh())
        _, pool_state = pool.reset(seed=1)
        pool_state, _ = pool.rollout_random(pool_state, 2, pool.REFRESH_CHUNK + 2)
        pool.step(pool_state, torch.zeros((16, 2), dtype=torch.int32))
    finally:
        graphs.graphs_on, Mesh.capturable, graphs.Graph = on, capturable, graph
    return {'digests': EagerGraph.digests}


def backend_rule() -> dict:
    """``graphed()`` from the backend: with graphs on (as on the card), a
    VectorEnv over this gloo mesh runs eagerly and one without a mesh
    would replay."""
    mesh = make_mesh()
    on = graphs.graphs_on
    graphs.graphs_on = lambda device: True
    try:
        env = make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu')
        sharded, plain = VectorEnv(env, 4, mesh=mesh).graphed(), VectorEnv(env, 4).graphed()
    finally:
        graphs.graphs_on = on
    return {'capturable': [distributed.capturable(None), distributed.capturable(mesh.group)],
            'mesh_capturable': mesh.capturable, 'graphed': [sharded, plain]}


def all_checks() -> dict:
    """Every check on the run's processes, in one process group."""
    return {'backend_rule': backend_rule(), 'gathers': gathers(), 'keys': key_checks(),
            'real_keys': real_keys(),
            'updates': {k: update_report(**kw) for k, kw in UPDATES.items()},
            'rollout': rollout_report()}
