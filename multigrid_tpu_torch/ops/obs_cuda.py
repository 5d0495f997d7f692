"""Observation generation through the hand-written CUDA kernel.

Counterpart of ``multigrid_tpu.ops.obs_pallas``: the kernels in
``csrc/obs.cu`` compute, per (env, agent), the same partial view as the
plain version in :mod:`.obs`, bit for bit. :func:`gen_obs_batched` is the
one entry point. It takes the plain version only for tensors on the CPU; for
CUDA tensors it launches a kernel or raises:

- ``obs_kernel``, which stages each env in shared memory, for every odd view
  of 3..31 (a view column is one 32-bit word) where one env's grid, views
  and visibility columns fit a block's shared memory;
- ``obs_general_kernel`` for every other odd view and grid and team (views
  of 33 and more, large grids, large teams of wide views), as the JAX
  package serves them through its XLA path: one warp an (env, agent) view,
  the view's window staged in shared memory (its plan of warps and column
  strips is the launcher's, ``csrc/obs.cu::general_plan``).

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

#: Launches of ``obs_kernel`` since the count was last set to 0; nothing
#: else adds to it.
launches = 0
#: Launches of ``obs_general_kernel`` since the count was last set to 0.
general_launches = 0

#: The view sizes ``obs_kernel`` takes: every odd size whose view column
#: fits one 32-bit word. Any team size is taken, as far as one env fits a
#: block's shared memory.
VIEW_SIZES = tuple(range(3, 33, 2))
#: Shared memory a block may use on Hopper.
MAX_SMEM_BYTES = 232448

_fns = {}


def _lib_fn(name):
    if name not in _fns:
        import ctypes

        from ..utils import build
        lib = build.load(SOURCE)
        fn = lib.mgt_obs_launch if name == 'obs' else lib.mgt_obs_general_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def smem_bytes(num_agents: int, width: int, height: int, view_size: int) -> int:
    """Shared memory one env takes in the kernel (a warp's share of its
    block, ``csrc/obs.cu::env_words``): the agents' view extents, packed
    grid, views and visibility columns, each rounded up to 16 bytes."""
    def round4(x):
        return -(-x // 4) * 4
    n, v = num_agents, view_size
    return 4 * (4 * n + round4(width * height) + round4(n * v * v) + round4(n * v))


def check_supported(num_agents: int, width: int, height: int, view_size: int) -> str:
    """The kernel that takes this shape, ``'obs'`` (``obs_kernel``) or
    ``'general'`` (``obs_general_kernel``); ValueError for a view size that
    is even or under 3 (no config of either package takes one), past
    464,896 cells, or more colors or states than the packed cells' 4 bits
    hold. The general kernel's launcher takes views to 92,975 cells, where
    one column of the staged window fills a block's shared memory, and
    refuses larger ones (a RuntimeError from :func:`gen_obs_batched`)."""
    if view_size < 3 or view_size % 2 == 0:
        raise ValueError(f'obs kernels take odd view sizes of at least 3, got {view_size}')
    if len(Color) > 16 or len(State) > 16:
        raise ValueError('obs kernels pack colors and states into 4 bits each')
    if 16 * -(-view_size // 32) > MAX_SMEM_BYTES:
        raise ValueError(f'a view column of {view_size} cells passes a block\'s shared memory')
    if view_size in VIEW_SIZES and \
            smem_bytes(num_agents, width, height, view_size) <= MAX_SMEM_BYTES:
        return 'obs'
    return 'general'


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

    CPU tensors take the plain version; CUDA tensors launch the kernel that
    :func:`check_supported` names.
    """
    global launches, general_launches
    dev = state.grid.device
    if dev.type == 'cpu':
        return gen_obs_batched_plain(state, view_size, see_through_walls, packed)
    if dev.type != 'cuda':
        raise ValueError(f'obs kernel runs on CUDA tensors, got {dev}')
    e, w, h, _ = state.grid.shape
    n = state.agent_dir.shape[-1]
    vs = view_size
    kernel = check_supported(n, w, h, vs)
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
        err = _lib_fn(kernel)(*ptrs, out.data_ptr(), e, n, w, h, vs,
                              int(see_through_walls), int(packed), stream)
    if err != 0:
        raise RuntimeError(f'obs kernel launch failed: CUDA error {err}')
    if kernel == 'obs':
        launches += 1
    else:
        general_launches += 1
    return out
