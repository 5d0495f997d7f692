"""The policy's first layer on packed cells, through hand-written CUDA kernels.

Counterpart of ``multigrid_tpu.ops.fused_linear``: ``one_hot(packed) @ W``
(kernel ``csrc/fused_linear.cu``, replacing ``_kernel``) and its weight
gradient ``one_hot(packed)ᵀ @ g`` (replacing ``_grad_kernel``), paired in
one ``torch.autograd.Function``, :func:`onehot_linear`. The weights keep
the flax layout (C·21, H), feature index ``cell·21 + ch``. Numerics follow
the TPU kernels: bf16 weights and ``g``, f32 sums, bf16 forward output,
f32 ``dW``.

Per-agent policies take both kernels with an agent axis, one launch for
all agents, as the JAX package ``vmap``s its kernels over stacked per-agent
weights (Pallas's batching rule adds a leading grid axis):
:func:`onehot_linear_agents_forward` and :func:`onehot_linear_agents_grad_w`
on (N, B, C) cells and (N, C·21, H) weights or (N, B, H) cotangents, and
:func:`onehot_linear` with those shapes. Each launch counts once.

Each wrapper takes its plain version (the one-hot product written out; with
the agent axis, the single-agent plain version agent by agent) for tensors
on the CPU; for CUDA tensors it launches its kernel or raises. The library
is built from the package's sources at first use
(:mod:`multigrid_tpu_torch.utils.build`).
"""

from __future__ import annotations

import functools

import torch

from ..core.constants import Color, State, Type

SOURCE = 'fused_linear.cu'

#: One-hot channel widths per encoding slot: type, color, max(state,
#: direction) (multigrid/wrappers.py:139-147).
OBS_CHANNELS = (len(Type), len(Color), max(len(State), 4))
NCH = sum(OBS_CHANNELS)

#: A packed cell that matches no channel (type 0x7FF, color and state 15).
PAD_CELL = (0x7FF << 8) | (15 << 4) | 15

#: Launches of the forward kernel (B2) and of the gradient kernel (B3)
#: through their wrappers since the counts were last set to 0 (a launch over
#: all agents counts once).
launches = 0
grad_launches = 0

#: The kernels' range: the forward takes any width up to 256 (64 x 128
#: tiles, at most two column tiles); the gradient kernel is built for these
#: widths.
MAX_HIDDEN = 256
GRAD_HIDDEN = (32, 64, 128, 256)
#: The gradient kernel's blocks: 12 cells (252 of 256 dW rows) x up to 128
#: columns, over a chunk of the batch that is a multiple of 128 samples
#: (its stage).
GRAD_CELLS_PER_BLOCK = 12
GRAD_COLS_PER_BLOCK = 128
GRAD_STAGE = 128

_fns = {}


def _lib_fn(name: str, nargs_ptr: int, nargs_int: int):
    if name not in _fns:
        import ctypes

        from ..utils import build
        fn = getattr(build.load(SOURCE), name)
        fn.argtypes = ([ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def one_hot_image(image: torch.Tensor, dtype=torch.bfloat16,
                  packed: bool = False) -> torch.Tensor:
    """Observation image → one-hot feature planes.

    ``packed=False``: (..., vs, vs, 3) channel triples → (..., vs, vs, 21).
    ``packed=True``: (..., C) packed cells ``type<<8 | color<<4 | state`` →
    (..., C, 21). A field out of its channel's range (a type of 11 or more,
    :data:`PAD_CELL`) matches no channel.
    """
    dev = image.device
    ch = torch.arange(NCH, device=dev)
    t, c = OBS_CHANNELS[0], OBS_CHANNELS[0] + OBS_CHANNELS[1]
    slot = (ch >= t).long() + (ch >= c).long()          # 0 type, 1 color, 2 state
    value = ch - torch.tensor([0, t, c], device=dev)[slot]
    if packed:
        shift = torch.tensor([8, 4, 0], device=dev)[slot]
        mask = torch.tensor([-1, 15, 15], device=dev)[slot]
        field = (image[..., None] >> shift) & mask
    else:
        field = image[..., slot]
    return (field == value).to(dtype)


def onehot_features(packed: torch.Tensor) -> torch.Tensor:
    """(B, C) packed cells → (B, C·21) float32 one-hot features."""
    return one_hot_image(packed, torch.float32, packed=True).flatten(1)


def onehot_linear_plain(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: (B, H) bf16."""
    return (onehot_features(packed) @ w.to(torch.bfloat16).float()).to(torch.bfloat16)


def onehot_linear_grad_w_plain(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the gradient kernel: (C·21, H) float32."""
    return onehot_features(packed).T @ g.to(torch.bfloat16).float()


def onehot_linear_agents_plain(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's agent axis: (N, B, H) bf16,
    agent ``i`` the single-agent plain version on ``packed[i]``, ``w[i]``."""
    return torch.stack([onehot_linear_plain(p, wi) for p, wi in zip(packed, w)])


def onehot_linear_agents_grad_w_plain(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the gradient kernel's agent axis: (N, C·21, H)
    float32, agent ``i`` the single-agent plain version on ``packed[i]``,
    ``g[i]``."""
    return torch.stack([onehot_linear_grad_w_plain(p, gi) for p, gi in zip(packed, g)])


def check_cuda(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype) -> int:
    """``t.data_ptr()`` of a contiguous CUDA tensor of ``shape`` and
    ``dtype``; ValueError for anything else."""
    if t.device.type != 'cuda' or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: kernel needs a contiguous {dtype} CUDA tensor of shape '
            f'{shape}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')
    return t.data_ptr()


def _check_shapes(packed: torch.Tensor, h: int, agents: bool = False) -> tuple[int, ...]:
    """``packed``'s shape, (B, C), or (N, B, C) with ``agents``; ValueError
    for another rank or a width past the kernels'."""
    if packed.dim() != 2 + agents:
        want = '(N, B, C)' if agents else '(B, C)'
        raise ValueError(f'packed cells must be {want}, got {tuple(packed.shape)}')
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f'the kernels take 1..{MAX_HIDDEN} columns, got {h}')
    return packed.shape


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pad_columns(w: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """``w`` with zero columns appended up to a multiple of ``multiple``:
    the forward kernel stages W's rows in 16-byte pieces, so a bf16 row
    must span a multiple of 8 columns. ``w`` itself where it already does."""
    pad = -w.shape[-1] % multiple
    return torch.nn.functional.pad(w, (0, pad)) if pad else w


def _forward_cuda(packed: torch.Tensor, w: torch.Tensor, agents: bool) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors, with the agent axis where
    ``agents`` (counts once)."""
    global launches
    h = w.shape[-1]
    shape = _check_shapes(packed, h, agents)
    n, (b, c) = (shape[0] if agents else 1), shape[-2:]
    lead = (n,) if agents else ()
    wb = pad_columns(w.detach().to(torch.bfloat16)).contiguous()
    if wb.data_ptr() % 16:
        wb = wb.clone()
    ldw = wb.shape[-1]
    ptrs = [check_cuda(packed, 'packed', lead + (b, c), torch.int32),
            check_cuda(wb, 'w', lead + (c * NCH, ldw), torch.bfloat16)]
    out = torch.empty(lead + (b, h), dtype=torch.bfloat16, device=packed.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(packed.device):
        if agents:
            err = _lib_fn('mgt_onehot_linear_agents_launch', 3, 5)(
                *ptrs, out.data_ptr(), n, b, c, h, ldw, _stream(packed.device))
        else:
            err = _lib_fn('mgt_onehot_linear_launch', 3, 4)(
                *ptrs, out.data_ptr(), b, c, h, ldw, _stream(packed.device))
    if err != 0:
        raise RuntimeError(f'onehot_linear kernel launch failed: CUDA error {err}')
    launches += 1
    return out


def onehot_linear_forward(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed) @ w`` → (B, H) bf16: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if packed.device.type == 'cpu':
        return onehot_linear_plain(packed, w)
    return _forward_cuda(packed, w, False)


def onehot_linear_agents_forward(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed[i]) @ w[i]`` for every agent ``i`` → (N, B, H) bf16
    from (N, B, C) int32 cells and (N, C·21, H) weights: one launch of the
    kernel over all agents for CUDA tensors (each row equal to the
    single-agent launch's), the plain version for CPU tensors."""
    if packed.device.type == 'cpu':
        return onehot_linear_agents_plain(packed, w)
    return _forward_cuda(packed, w, True)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, looked up once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def grad_plan(b: int, c: int, h: int, sms: int, agents: int = 1) -> tuple[int, int]:
    """``(chunks, chunk)``: how the gradient kernel splits a batch of ``b``
    samples (each agent's, with ``agents``). Chunk ``k`` takes samples
    ``[k·chunk, min(b, (k+1)·chunk))``; ``chunk`` is a multiple of the
    128-sample stage, no chunk is empty, and the blocks (cell tiles ×
    column tiles × chunks × agents) fit on the ``sms`` SMs in one wave, one
    block an SM, with chunks of at least 256 samples. The plan depends on
    the shapes only, so the sums' order is the same from run to run."""
    tiles = -(-c // GRAD_CELLS_PER_BLOCK) * -(-h // GRAD_COLS_PER_BLOCK)
    b = max(b, 1)
    chunks = max(1, min(-(-b // 256), sms // (tiles * agents)))
    per_chunk = -(-b // chunks)
    chunk = -(-per_chunk // GRAD_STAGE) * GRAD_STAGE
    return -(-b // chunk), chunk


def grad_w_cuda(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the gradient kernel on CUDA tensors (no count): (C·21, H) f32
    from (B, C) cells, or (N, C·21, H) from (N, B, C) cells, one launch for
    all agents. ``g`` must be bf16 already, (B, H) or (N, B, H)."""
    h = g.shape[-1]
    agents = packed.dim() == 3
    shape = _check_shapes(packed, h, agents)
    n, (b, c) = (shape[0] if agents else 1), shape[-2:]
    lead = (n,) if agents else ()
    if h not in GRAD_HIDDEN:
        raise ValueError(f'the gradient kernel takes {GRAD_HIDDEN} columns, got {h}')
    dev = packed.device
    if g.data_ptr() % 16:  # the kernel stages g's rows in 16-byte pieces
        g = g.clone()
    ptrs = [check_cuda(packed, 'packed', lead + (b, c), torch.int32),
            check_cuda(g, 'g', lead + (b, h), torch.bfloat16)]
    if b == 0 or n == 0:
        return torch.zeros(lead + (c * NCH, h), dtype=torch.float32, device=dev)
    out = torch.empty(lead + (c * NCH, h), dtype=torch.float32, device=dev)  # all written
    chunks, chunk = grad_plan(b, c, h, sm_count(dev), n)
    partial = torch.empty((n * chunks if chunks > 1 else 0, c * NCH, h),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if agents:
            err = _lib_fn('mgt_onehot_grad_agents_launch', 4, 6)(
                *ptrs, partial.data_ptr(), out.data_ptr(), n, b, c, h, chunks, chunk,
                _stream(dev))
        else:
            err = _lib_fn('mgt_onehot_grad_launch', 4, 5)(
                *ptrs, partial.data_ptr(), out.data_ptr(), b, c, h, chunks, chunk,
                _stream(dev))
    if err != 0:
        raise RuntimeError(f'onehot_linear gradient kernel launch failed: error {err}')
    return out


def _grad_w_counted(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    global grad_launches
    out = grad_w_cuda(packed, g.to(torch.bfloat16).contiguous())
    grad_launches += 1
    return out


def onehot_linear_grad_w(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed)ᵀ @ bf16(g)`` → (C·21, H) float32: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if packed.device.type == 'cpu':
        return onehot_linear_grad_w_plain(packed, g)
    _check_shapes(packed, g.shape[-1])
    return _grad_w_counted(packed, g)


def onehot_linear_agents_grad_w(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed[i])ᵀ @ bf16(g[i])`` for every agent ``i`` → (N,
    C·21, H) float32 from (N, B, C) cells and (N, B, H) cotangents: one
    launch of the kernel (and of its partials' sum) over all agents for CUDA
    tensors, the plain version for CPU tensors."""
    if packed.device.type == 'cpu':
        return onehot_linear_agents_grad_w_plain(packed, g)
    _check_shapes(packed, g.shape[-1], True)
    return _grad_w_counted(packed, g)


class _OneHotLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, packed, w):
        ctx.save_for_backward(packed)
        if packed.dim() == 3:
            return onehot_linear_agents_forward(packed, w)
        return onehot_linear_forward(packed, w)

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None
        if packed.dim() == 3:
            return None, onehot_linear_agents_grad_w(packed, g)
        return None, onehot_linear_grad_w(packed, g)


def onehot_linear(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``one_hot(packed) @ w`` → (B, H) bf16 from (B, C)
    int32 packed cells and (C·21, H) float32 weights, or with an agent axis
    (N, B, H) from (N, B, C) cells and stacked (N, C·21, H) weights (one
    launch for all agents). Its backward is the gradient kernel;
    ``packed`` (integer data) has no gradient."""
    return _OneHotLinear.apply(packed, w)
