"""The yardstick's arithmetic: the card's peaks and each kernel's least
time, reckoned from a cell's shapes and the JAX package's state layout
(never from the port's tensors), so that a roofline reads the same work
whatever implements it.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores, 989
TFLOP/s of bf16 on them. A bound is the larger of the bytes over the
memory rate and the operations over their rates: each input byte counted
read once and each output byte written once.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
TENSOR_OPS_PER_S = 989e12


@dataclasses.dataclass(frozen=True)
class Shapes:
    """A batch of MultiGrid states as the JAX package lays it out: ``E``
    envs, ``N`` agents, a ``W × H`` grid of int32 (type, color, state)
    triples, a Box-contents table of the grid's shape where the env can
    hold a Box (else none), per-agent int32 positions (2), direction,
    color, carried object and its contents (3 each) and a bool
    termination flag."""
    envs: int
    agents: int
    width: int
    height: int
    boxes: bool
    view: int = 7


def bound_s(nbytes: float, vector_ops: float = 0, tensor_ops: float = 0) -> float:
    """The least seconds of ``nbytes`` moved and the operations done."""
    return max(nbytes / HBM_BYTES_PER_S,
               vector_ops / VECTOR_OPS_PER_S + tensor_ops / TENSOR_OPS_PER_S)


def state_bytes(s: Shapes) -> int:
    """The bytes S1 reads and writes of a state: the grid, the box table,
    and the agents' positions, directions, carried objects, their contents
    and the termination flags."""
    e, n = s.envs, s.agents
    grid = e * s.width * s.height * 3 * 4
    return (grid * (2 if s.boxes else 1) + e * n * 2 * 4 + e * n * 4
            + 2 * e * n * 3 * 4 + e * n)


def step_bound_s(s: Shapes) -> float:
    """S1, one env step: the state read once and written once, actions,
    orders and rewards (4 bytes an agent each) and the step counts, against
    about 60 integer operations a sub-step and 3 an agent of its occupancy
    test (chip_smoke.py::step_bound)."""
    e, n = s.envs, s.agents
    nbytes = 2 * state_bytes(s) + e * n * 4 * 3 + e * 4
    return bound_s(nbytes, vector_ops=e * n * (60 + 3 * n))


def obs_bound_s(s: Shapes, packed: bool = True) -> float:
    """B1, one observation of every agent: the grid and the agents' fields
    read once, the views written once (one int32 a packed cell, three an
    unpacked one), against about 28 integer operations an output cell and
    4 a grid cell (chip_smoke.py::obs_bound)."""
    e, n, vs = s.envs, s.agents, s.view
    cells = e * n * vs * vs
    grid = e * s.width * s.height * 3 * 4
    read = grid + e * n * 2 * 4 + e * n * 4 * 2 + e * n + e * n * 3 * 4
    written = cells * (1 if packed else 3) * 4
    return bound_s(read + written, vector_ops=cells * 28 + e * s.width * s.height * 4)


@dataclasses.dataclass(frozen=True)
class NetShapes:
    """The mlp actor-critic on packed cells: ``cells`` cells a view (each a
    21-channel one-hot), ``hidden`` units, ``features`` direction and
    mission features (2 + missions) and ``actions`` logits."""
    cells: int
    hidden: int
    features: int
    actions: int = 7

    @property
    def first_layer_flops(self) -> int:
        """One sample's first layer as a dense one-hot product."""
        return 2 * self.cells * 21 * self.hidden

    @property
    def forward_flops(self) -> int:
        """One sample's forward: the first layer, ``Dense_0`` (features),
        ``Dense_1`` (hidden), the logits and the value."""
        h = self.hidden
        return self.first_layer_flops + 2 * h * (self.features + h + self.actions + 1)

    @property
    def param_bytes(self) -> int:
        h, f, a = self.hidden, self.features, self.actions
        return 4 * (self.cells * 21 * h + f * h + h + h * h + h + h * a + a + h + 1)


def update_flops(envs: int, agents: int, net: NetShapes, rollout_steps: int,
                 epochs: int) -> int:
    """The model FLOPs of one PPO update as the JAX package's XLA path
    computes them: the forward of every sample in the rollout and of its
    last observation, then each epoch's forward and backward over the
    batch, the backward twice the forward but for the first layer's, which
    computes its weights' gradient alone."""
    samples = envs * agents
    backward = 2 * (net.forward_flops - net.first_layer_flops) + net.first_layer_flops
    return (samples * (rollout_steps + 1) * net.forward_flops
            + epochs * rollout_steps * samples * (net.forward_flops + backward))


def onehot_linear_bound_s(batch: int, net: NetShapes) -> float:
    """B2, one first layer of ``batch`` samples: the packed cells and the
    float32 weights read, the bf16 output written, against the dense
    one-hot product on the tensor cores (chip_smoke.py's B2 bound)."""
    c, h = net.cells, net.hidden
    nbytes = batch * c * 4 + c * 21 * h * 4 + batch * h * 2
    return bound_s(nbytes, tensor_ops=2 * batch * c * 21 * h)


def ppo_loss_bound_s(batch: int, net: NetShapes) -> float:
    """B4 with B3's stage, one minibatch of ``batch`` samples: the
    per-sample inputs (packed cells, float32 direction features, action,
    old log-probability, advantage, target) and the float32 parameters
    read, their gradients written, against the dense products of the
    trunk and heads forward and backward and two one-hot products (the
    first layer and its weights' gradient) on the tensor cores
    (chip_smoke.py's B4 bound)."""
    c, h, f = net.cells, net.hidden, net.features
    inputs = batch * (c * 4 + f * 4 + 4 * 4)
    dense = 2 * batch * (2 * (f + 1) * h + 3 * h * h + 3 * h * 8)
    return bound_s(inputs + 2 * net.param_bytes,
                   tensor_ops=dense + 2 * (2 * batch * c * 21 * h))
