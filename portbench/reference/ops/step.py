"""The environment transition on batched tensors.

Counterpart of ``multigrid_tpu.ops.step``, on states with a leading env axis
``E``. Agents act **sequentially in a given per-env order** (conflicts are
resolved by order, not simultaneously): sub-step ``t`` applies the action of
agent ``order[:, t]`` in every env at once, reading and writing that agent's
fields and its forward cell with plain batched indexing.

Exact semantics (the reference is multigrid/base.py):

* left/right: ``dir = (dir ∓ 1) % 4``                      (base.py:412-417)
* forward: target must be empty/goal/floor/lava/open-door  (base.py:420-436);
  optional agent-occupancy block including terminated agents
  (base.py:425-429); landing on goal → success, lava → failure
* pickup: fwd is key/ball/box and hands empty               (base.py:439-446)
* drop: carrying, fwd cell empty, and no agent there        (base.py:449-459)
* toggle: Door unlock-with-matching-key / open-close flip; Box replaced by
  its contents
* done: no-op                                               (base.py:470-471)
* success/failure side effects: termination modes 'any'/'all', joint vs.
  individual reward ``1 - 0.9·step_count/max_steps``, *assigned*, not added
  (base.py:478-532, 598-602)

The input state is not modified: the step works on copies of the tensors it
writes. :func:`handle_actions` takes :func:`handle_actions_plain` for tensors
on the CPU and the CUDA kernel (``ops/step_cuda.py``, ``csrc/step.cu``) for
tensors on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.actions import Action
from ..core.config import EnvConfig
from ..core.constants import (
    DIR_TO_VEC,
    EMPTY_ENCODING,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_WALL,
)
from ..core.state import MultiGridState
from ..utils import prng
from ..utils.device import constant


_A_LEFT = int(Action.left)
_A_RIGHT = int(Action.right)
_A_FORWARD = int(Action.forward)
_A_PICKUP = int(Action.pickup)
_A_DROP = int(Action.drop)
_A_TOGGLE = int(Action.toggle)


def can_overlap(cell_type: torch.Tensor, cell_state: torch.Tensor) -> torch.Tensor:
    """Whether an agent may walk onto a cell with this encoding: empty, goal,
    floor, lava and open doors."""
    return (
        (cell_type == TYPE_EMPTY)
        | (cell_type == TYPE_GOAL)
        | (cell_type == TYPE_FLOOR)
        | (cell_type == TYPE_LAVA)
        | ((cell_type == TYPE_DOOR) & (cell_state == STATE_OPEN))
    )


def can_pickup(cell_type: torch.Tensor) -> torch.Tensor:
    """Whether an agent may pick up a cell's object (key/ball/box)."""
    return (cell_type == TYPE_KEY) | (cell_type == TYPE_BALL) | (cell_type == TYPE_BOX)


def apply_success(
    cfg: EnvConfig,
    agent_mask: torch.Tensor,
    fire: torch.Tensor,
    terminated: torch.Tensor,
    rewards: torch.Tensor,
    reward_value: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``MultiGridEnv.on_success`` (base.py:478-507).

    ``agent_mask`` (E, N) selects the acting agent, ``fire`` (E,) says where
    it succeeded. There, terminate all agents ('any') or the acting one
    ('all'), and *assign* the reward to all agents (joint) or the acting one.
    """
    fire = fire[:, None]
    term_on = torch.ones_like(terminated) if cfg.success_any \
        else terminated | agent_mask
    terminated = torch.where(fire, term_on, terminated)
    value = reward_value[:, None].expand_as(rewards)
    rew_on = value if cfg.joint_reward \
        else torch.where(agent_mask, value, rewards)
    return terminated, torch.where(fire, rew_on, rewards)


def apply_failure(
    cfg: EnvConfig,
    agent_mask: torch.Tensor,
    fire: torch.Tensor,
    terminated: torch.Tensor,
) -> torch.Tensor:
    """Batched ``MultiGridEnv.on_failure`` (base.py:509-532): zero reward,
    only termination flags change."""
    term_on = torch.ones_like(terminated) if cfg.failure_any \
        else terminated | agent_mask
    return torch.where(fire[:, None], term_on, terminated)


def success_reward_k(max_steps: int) -> float:
    """The success reward's factor ``k = f32(0.9) · f32(1/max_steps)``,
    rounded to float32 as XLA folds it (see :func:`success_reward`)."""
    return float(np.float32(0.9) * (np.float32(1.0) / np.float32(max_steps)))


def success_reward(step_count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """(E,) float32 success reward ``1 - 0.9·step_count/max_steps``
    (base.py:598-602), rounded as the JAX package computes it.

    XLA folds the constants of ``1.0 - 0.9 * step / max_steps`` into
    ``k = f32(0.9) · f32(1/max_steps)`` and contracts the rest into one fused
    multiply-add, ``1 - step·k`` rounded once. That differs from the
    operation-by-operation float32 result in the last bits for some step
    counts. Here the product of two float32 values is exact in float64, and
    the difference is rounded to float32 at the end.
    """
    k = success_reward_k(max_steps)
    return (1.0 - step_count.to(torch.float64) * k).to(torch.float32)


def handle_actions(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: torch.Tensor,
    order: torch.Tensor,
    action_mask: torch.Tensor | None = None,
) -> tuple[MultiGridState, torch.Tensor]:
    """Apply all agents' actions sequentially in ``order``: on the CPU
    :func:`handle_actions_plain`; on the card one launch of the CUDA kernel
    (:func:`multigrid_tpu_torch.ops.step_cuda.handle_actions`), which
    computes the same bits, or an error. Arguments and results as
    :func:`handle_actions_plain`'s."""
    return handle_actions_plain(cfg, state, actions, order, action_mask)


def handle_actions_plain(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: torch.Tensor,
    order: torch.Tensor,
    action_mask: torch.Tensor | None = None,
) -> tuple[MultiGridState, torch.Tensor]:
    """Apply all agents' actions sequentially in ``order``, in batched torch
    operations: the CUDA kernel's plain version.

    Parameters
    ----------
    cfg : EnvConfig
    state : MultiGridState
        State *after* the step counter has been incremented (the success
        reward reads the incremented count, base.py:602).
    actions : (E, N) int
    order : (E, N) int
        Per-env permutation in which agents act (base.py:396-399).
    action_mask : (E, N) bool, optional
        Which agents have an action this step (base.py:403-404).

    Returns ``(state, rewards)`` with rewards (E, N) float32.
    """
    dev = state.device
    e, n = state.agent_dir.shape
    w, h = cfg.width, cfg.height
    if action_mask is None:
        action_mask = torch.ones((e, n), dtype=torch.bool, device=dev)
    actions = actions.to(device=dev, dtype=torch.int32)
    order = order.to(device=dev, dtype=torch.long)

    empty = constant(EMPTY_ENCODING, dev, torch.int32)
    dir_vec = constant(DIR_TO_VEC, dev, torch.int32)
    reward_value = success_reward(state.step_count, cfg.max_steps)
    rewards = torch.zeros((e, n), dtype=torch.float32, device=dev)

    grid = state.grid.clone()
    has_boxes = state.box_contents.numel() > 0
    box_contents = state.box_contents.clone() if has_boxes else state.box_contents
    agent_pos = state.agent_pos.clone()
    agent_dir = state.agent_dir.clone()
    carrying_all = state.agent_carrying.clone()
    contents_all = state.agent_carrying_contents.clone()
    terminated = state.agent_terminated.clone()

    env = torch.arange(e, device=dev)
    agent_iota = torch.arange(n, device=dev)

    for t in range(n):
        i = order[:, t]
        sel = agent_iota[None, :] == i[:, None]          # (E, N) acting agent
        pos = agent_pos[env, i]
        dirn = agent_dir[env, i]
        carrying = carrying_all[env, i]
        carrying_contents = contents_all[env, i]
        act = actions[env, i]
        active = action_mask[env, i] & ~terminated[env, i]

        # --- rotations -------------------------------------------------------
        is_left = active & (act == _A_LEFT)
        is_right = active & (act == _A_RIGHT)
        new_dir = torch.where(
            is_left, (dirn - 1) % 4, torch.where(is_right, (dirn + 1) % 4, dirn))

        # --- forward cell (shared by forward/pickup/drop/toggle) ------------
        # An unplaced agent (dir -1) has no forward offset.
        dir_ok = (dirn >= 0) & (dirn < 4)
        step = torch.where(dir_ok[:, None], dir_vec[dirn.clamp(0, 3).long()], 0)
        fwd = pos + step
        in_bounds = ((fwd[:, 0] >= 0) & (fwd[:, 0] < w)
                     & (fwd[:, 1] >= 0) & (fwd[:, 1] < h))
        fx = fwd[:, 0].clamp(0, w - 1).long()
        fy = fwd[:, 1].clamp(0, h - 1).long()
        fwd_enc = torch.where(in_bounds[:, None], grid[env, fx, fy], 0)
        ftype = torch.where(in_bounds, fwd_enc[:, 0], TYPE_WALL)
        fcolor = fwd_enc[:, 1]
        fstate = fwd_enc[:, 2]
        # Any agent, terminated ones included, on the forward cell
        # (base.py:425-429,454-455 compare against all positions).
        agent_at_fwd = (agent_pos == fwd[:, None, :]).all(-1).any(-1)

        # --- forward ---------------------------------------------------------
        move_ok = active & (act == _A_FORWARD) & can_overlap(ftype, fstate)
        if not cfg.allow_agent_overlap:
            move_ok = move_ok & ~agent_at_fwd
        new_pos = torch.where(move_ok[:, None], fwd, pos)
        success = move_ok & (ftype == TYPE_GOAL)
        failure = move_ok & (ftype == TYPE_LAVA)

        # --- pickup / drop ---------------------------------------------------
        is_carrying = carrying[:, 0] != TYPE_EMPTY
        do_pickup = active & (act == _A_PICKUP) & can_pickup(ftype) & ~is_carrying
        do_drop = (active & (act == _A_DROP) & is_carrying
                   & (ftype == TYPE_EMPTY) & ~agent_at_fwd)

        # --- toggle ----------------------------------------------------------
        is_toggle = active & (act == _A_TOGGLE)
        has_matching_key = (carrying[:, 0] == TYPE_KEY) & (carrying[:, 1] == fcolor)
        new_door_state = torch.where(
            fstate == STATE_LOCKED,
            torch.where(has_matching_key, STATE_OPEN, STATE_LOCKED),
            torch.where(fstate == STATE_OPEN, STATE_CLOSED, STATE_OPEN),
        ).to(torch.int32)
        do_toggle_door = is_toggle & (ftype == TYPE_DOOR)
        do_toggle_box = is_toggle & (ftype == TYPE_BOX)

        # --- the forward cell's new encoding ---------------------------------
        if has_boxes:
            box_cont = torch.where(
                in_bounds[:, None], box_contents[env, fx, fy], 0)
        else:
            box_cont = empty.expand(e, 3)
        door_cell = torch.stack([fwd_enc[:, 0], fwd_enc[:, 1], new_door_state], -1)
        cell = fwd_enc
        cell = torch.where(do_pickup[:, None], empty, cell)
        cell = torch.where(do_drop[:, None], carrying, cell)
        cell = torch.where(do_toggle_door[:, None], door_cell, cell)
        cell = torch.where(do_toggle_box[:, None], box_cont, cell)

        cont_cell = torch.where((do_pickup | do_toggle_box)[:, None], empty, box_cont)
        cont_cell = torch.where(do_drop[:, None], carrying_contents, cont_cell)

        new_carrying = torch.where(
            do_pickup[:, None], fwd_enc,
            torch.where(do_drop[:, None], empty, carrying))
        new_carrying_contents = torch.where(
            do_pickup[:, None], box_cont,
            torch.where(do_drop[:, None], empty, carrying_contents))

        # --- success / failure side effects ---------------------------------
        terminated, rewards = apply_success(
            cfg, sel, success, terminated, rewards, reward_value)
        terminated = apply_failure(cfg, sel, failure, terminated)

        # --- writes: one cell and one agent per env --------------------------
        changed = (do_pickup | do_drop | do_toggle_door | do_toggle_box)[:, None]
        grid[env, fx, fy] = torch.where(changed, cell, grid[env, fx, fy])
        if has_boxes:
            box_contents[env, fx, fy] = torch.where(
                changed, cont_cell, box_contents[env, fx, fy])
        agent_pos[env, i] = new_pos
        agent_dir[env, i] = new_dir
        carrying_all[env, i] = new_carrying
        contents_all[env, i] = new_carrying_contents

    state = state.replace(
        grid=grid,
        box_contents=box_contents,
        agent_pos=agent_pos,
        agent_dir=agent_dir,
        agent_carrying=carrying_all,
        agent_carrying_contents=contents_all,
        agent_terminated=terminated,
    )
    return state, rewards


def step_with_order(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: torch.Tensor,
    order: torch.Tensor,
    action_mask: torch.Tensor | None = None,
) -> tuple[MultiGridState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic step core: increments the counter, applies actions.

    Returns ``(state, rewards, terminations, truncations)``, each (E, N):
    terminations are read from agent state after the action loop
    (base.py:338), truncation is ``step_count >= max_steps`` broadcast to all
    agents (base.py:339-340).
    """
    state = state.replace(step_count=state.step_count + 1)
    state, rewards = handle_actions(cfg, state, actions, order, action_mask)
    truncated = state.step_count >= cfg.max_steps
    truncations = truncated[:, None].expand(-1, cfg.num_agents)
    return state, rewards, state.agent_terminated, truncations


def sample_order(keys: torch.Tensor, num_agents: int) -> torch.Tensor:
    """(E, N) int32 random agent action orders, one permutation per env,
    from each env's order key (E, 2): the stable argsort of
    ``uniform(key, (N,))`` (multigrid_tpu/ops/step.py:363-371).

    The reference draws ``np_random.random(N).argsort()`` (base.py:396-399);
    single-agent environments use ``(0,)`` and consume no randomness. A step
    draws its order with the rest of its draws, one launch of the
    step-draws kernel on the card
    (:func:`multigrid_tpu_torch.utils.prng.step_draws`).
    """
    if num_agents == 1:
        return torch.zeros((keys.shape[0], 1), dtype=torch.int32, device=keys.device)
    u = prng.uniform(keys, (num_agents,))
    return torch.argsort(u, dim=-1, stable=True).to(torch.int32)
