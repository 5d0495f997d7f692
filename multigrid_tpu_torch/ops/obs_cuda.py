"""Observation generation through the hand-written CUDA kernel.

Counterpart of ``multigrid_tpu.ops.obs_pallas``: the kernel in
``csrc/obs.cu`` computes, per (env, agent), the same partial view as the
plain version in :mod:`.obs`, bit for bit. :func:`gen_obs_batched` is the
one entry point. It takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

The library is built from the package's sources at first use (see
:mod:`multigrid_tpu_torch.utils.build`); this module imports without a CUDA
toolkit.
"""

from __future__ import annotations

import torch

from ..core.constants import Color, State
from ..core.state import MultiGridState
from .obs import gen_obs_batched_plain

SOURCE = 'obs.cu'

#: Kernel launches since the count was last set to 0; nothing else adds to it.
launches = 0

#: The view sizes the kernel takes: every odd size whose view column fits
#: one 32-bit word. Any team size is taken, as far as one env fits a block's
#: shared memory.
VIEW_SIZES = tuple(range(3, 33, 2))
#: Shared memory a block may use on Hopper.
MAX_SMEM_BYTES = 232448

_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        import ctypes

        from ..utils import build
        lib = build.load(SOURCE)
        fn = lib.mgt_obs_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(num_agents: int, width: int, height: int, view_size: int) -> int:
    """Shared memory one env takes in the kernel (a warp's share of its
    block, ``csrc/obs.cu::env_words``): the agents' view extents, packed
    grid, views and visibility columns, each rounded up to 16 bytes."""
    def round4(x):
        return -(-x // 4) * 4
    n, v = num_agents, view_size
    return 4 * (4 * n + round4(width * height) + round4(n * v * v) + round4(n * v))


def check_supported(num_agents: int, width: int, height: int, view_size: int) -> None:
    """Raise ValueError for a shape the kernel does not take: a view size
    that is not odd in 3..31 (a view column is one 32-bit word), or an env
    whose grid, views and visibility columns need more shared memory than a
    block can have."""
    if view_size not in VIEW_SIZES:
        raise ValueError(f'obs kernel takes odd view sizes 3..31 (a view column is one '
                         f'32-bit word), got {view_size}')
    if len(Color) > 16 or len(State) > 16:
        raise ValueError('obs kernel packs colors and states into 4 bits each')
    need = smem_bytes(num_agents, width, height, view_size)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f'one env of {num_agents} agents with view {view_size} on a {width}x{height} '
            f'grid needs {need} bytes of shared memory, more than the {MAX_SMEM_BYTES} a '
            f'block can have')


def _checked(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype):
    if t.device.type != 'cuda' or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: kernel needs a contiguous {dtype} CUDA tensor of shape '
            f'{shape}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')
    return t.data_ptr()


def gen_obs_batched(
    state: MultiGridState,
    view_size: int,
    see_through_walls: bool,
    packed: bool = False,
) -> torch.Tensor:
    """Observation images (E, N, vs, vs, 3) int32, or packed cells
    (E, N, vs·vs) int32 ``t<<8 | c<<4 | s`` with ``packed=True``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    dev = state.grid.device
    if dev.type == 'cpu':
        return gen_obs_batched_plain(state, view_size, see_through_walls, packed)
    if dev.type != 'cuda':
        raise ValueError(f'obs kernel runs on CUDA tensors, got {dev}')
    e, w, h, _ = state.grid.shape
    n = state.agent_dir.shape[-1]
    vs = view_size
    check_supported(n, w, h, vs)
    out_shape = (e, n, vs * vs) if packed else (e, n, vs, vs, 3)
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    if e == 0:
        return out
    ptrs = [
        _checked(state.grid, 'grid', (e, w, h, 3), torch.int32),
        _checked(state.agent_pos, 'agent_pos', (e, n, 2), torch.int32),
        _checked(state.agent_dir, 'agent_dir', (e, n), torch.int32),
        _checked(state.agent_color, 'agent_color', (e, n), torch.int32),
        _checked(state.agent_terminated, 'agent_terminated', (e, n), torch.bool),
        _checked(state.agent_carrying, 'agent_carrying', (e, n, 3), torch.int32),
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn()(*ptrs, out.data_ptr(), e, n, w, h, vs,
                           int(see_through_walls), int(packed), stream)
    if err != 0:
        raise RuntimeError(f'obs kernel launch failed: CUDA error {err}')
    launches += 1
    return out
