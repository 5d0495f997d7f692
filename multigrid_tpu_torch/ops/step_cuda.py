"""The env step's action loop through the hand-written CUDA kernel.

Counterpart of ``multigrid_tpu.ops.step.handle_actions``, which XLA fuses
into a few elementwise passes over the env batch: ``csrc/step.cu`` applies
every agent's action in its env's order in one launch (the staged kernel,
or the global one where two of its stages do not fit a block or a tensor's
address is no multiple of 16; :func:`plan` says which), bit-equal to the
plain version
:func:`multigrid_tpu_torch.ops.step.handle_actions_plain`.
:func:`multigrid_tpu_torch.ops.step.handle_actions` is the entry point; it
takes the plain version for tensors on the CPU and :func:`handle_actions`
here for CUDA tensors, which launches the kernel or raises.

The library is built from the package's sources at first use (see
:mod:`multigrid_tpu_torch.utils.build`); this module imports without a CUDA
toolkit.
"""

from __future__ import annotations

import torch

from ..core.config import EnvConfig
from ..core.state import MultiGridState

SOURCE = 'step.cu'

#: Launches of the step kernel (either variant) since the count was last
#: set to 0; nothing else adds to it.
launches = 0

_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        import ctypes

        from ..utils import build
        fn = build.load(SOURCE).mgt_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


PLAN_KEYS = ('staged', 'chunk', 'warps', 'depth', 'blocks', 'threads', 'chunks', 'stage_bytes',
             'smem_bytes')


def plan(e: int, n: int, w: int, h: int, boxes: bool, mask: bool = False,
         aligned: bool = True) -> dict:
    """The plan a launch takes on the current card (``csrc/step_plan.cuh``):
    ``variant`` ``'staged'`` or ``'global'``, and ``PLAN_KEYS`` past the
    first (for the global kernel ``chunk`` is its envs a block);
    ``aligned``: whether every tensor's address is a multiple of 16."""
    import ctypes

    from ..utils import build
    fn = build.load(SOURCE).mgt_step_plan
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    fn(e, n, w, h, int(boxes), int(mask), int(aligned), out)
    res = dict(zip(PLAN_KEYS, out))
    return {'variant': 'staged' if res.pop('staged') else 'global', **res}


def _checked(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype) -> int:
    if t.device.type != 'cuda' or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: kernel needs a contiguous {dtype} CUDA tensor of shape '
            f'{shape}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')
    return t.data_ptr()


def handle_actions(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: torch.Tensor,
    order: torch.Tensor,
    action_mask: torch.Tensor | None,
    k: float,
) -> tuple[MultiGridState, torch.Tensor]:
    """``(state, rewards)`` after every agent's action, from one launch of
    the step kernel on the current stream; ``k`` is the success reward's
    factor (:func:`multigrid_tpu_torch.ops.step.success_reward_k`).

    The state's fields must be CUDA tensors of their documented dtypes
    (``core/state.py``); ``actions``, ``order`` and the mask are moved to
    the state's device and cast (int32, int32, bool). Raises ValueError for
    anything else. No host synchronization: a CUDA graph captures it.
    """
    global launches
    dev = state.device
    if dev.type != 'cuda':
        raise ValueError(f'step kernel runs on CUDA tensors, got {dev}')
    e, n = state.agent_dir.shape
    w, h = cfg.width, cfg.height
    names = ('grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_carrying',
             'agent_carrying_contents', 'agent_terminated')
    fields = {name: getattr(state, name).contiguous() for name in names}
    has_boxes = fields['box_contents'].numel() > 0
    shapes = {'grid': ((e, w, h, 3), torch.int32),
              'box_contents': ((e, w, h, 3) if has_boxes else (e, 0, 0, 3), torch.int32),
              'agent_pos': ((e, n, 2), torch.int32), 'agent_dir': ((e, n), torch.int32),
              'agent_carrying': ((e, n, 3), torch.int32),
              'agent_carrying_contents': ((e, n, 3), torch.int32),
              'agent_terminated': ((e, n), torch.bool)}
    # The input state is never written: post_step reads the state before
    # the actions, and the observed state may be another.
    outs = {name: torch.empty_like(t) for name, t in fields.items()}
    ptrs = [_checked(fields[name], name, *shapes[name]) for name in names] + \
        [t.data_ptr() for t in outs.values()]
    if not has_boxes:  # null pointers; the empty table passes through
        ptrs[1] = ptrs[len(names) + 1] = None
        outs['box_contents'] = state.box_contents
    rewards = torch.empty((e, n), dtype=torch.float32, device=dev)
    actions = actions.to(device=dev, dtype=torch.int32).contiguous()
    order = order.to(device=dev, dtype=torch.int32).contiguous()
    mask = None if action_mask is None else \
        action_mask.to(device=dev, dtype=torch.bool).contiguous()
    step_count = state.step_count.contiguous()
    args = [
        *ptrs,
        rewards.data_ptr(),
        _checked(actions, 'actions', (e, n), torch.int32),
        _checked(order, 'order', (e, n), torch.int32),
        None if mask is None else _checked(mask, 'action_mask', (e, n), torch.bool),
        _checked(step_count, 'step_count', (e,), torch.int32),
    ]
    if e > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib_fn()(*args, e, n, w, h, int(cfg.allow_agent_overlap),
                            int(cfg.success_any), int(cfg.failure_any), int(cfg.joint_reward),
                            k, stream)
        if err != 0:
            raise RuntimeError(f'step kernel launch failed: CUDA error {err}')
        launches += 1
    return state.replace(**outs), rewards
