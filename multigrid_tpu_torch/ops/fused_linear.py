"""The policy's first layer on packed cells, through hand-written CUDA kernels.

Counterpart of ``multigrid_tpu.ops.fused_linear``: ``one_hot(packed) @ W``
(kernel ``csrc/fused_linear.cu``, replacing ``_kernel``) and its weight
gradient ``one_hot(packed)ᵀ @ g`` (replacing ``_grad_kernel``), paired in
one ``torch.autograd.Function``, :func:`onehot_linear`. The weights keep
the flax layout (C·21, H), feature index ``cell·21 + ch``. Numerics follow
the TPU kernels: bf16 weights and ``g``, f32 sums, bf16 forward output,
f32 ``dW``.

Each wrapper takes its plain version (the one-hot product written out) for
tensors on the CPU; for CUDA tensors it launches its kernel or raises. The
library is built from the package's sources at first use
(:mod:`multigrid_tpu_torch.utils.build`).
"""

from __future__ import annotations

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
#: through their wrappers since the counts were last set to 0.
launches = 0
grad_launches = 0

#: The kernels' range: the forward takes any width up to 256 (64 x 128
#: tiles, at most two column tiles); the gradient kernel is built for these
#: widths.
MAX_HIDDEN = 256
GRAD_HIDDEN = (32, 64, 128, 256)
#: Rows of cells one gradient block covers (6 cells: 126 of 128 rows).
GRAD_CELLS_PER_BLOCK = 6

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


def _check_shapes(packed: torch.Tensor, h: int) -> tuple[int, int]:
    if packed.dim() != 2:
        raise ValueError(f'packed cells must be (B, C), got {tuple(packed.shape)}')
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


def onehot_linear_forward(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed) @ w`` → (B, H) bf16: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    global launches
    if packed.device.type == 'cpu':
        return onehot_linear_plain(packed, w)
    h = w.shape[-1]
    b, c = _check_shapes(packed, h)
    wb = pad_columns(w.detach().to(torch.bfloat16)).contiguous()
    if wb.data_ptr() % 16:
        wb = wb.clone()
    ldw = wb.shape[-1]
    ptrs = [check_cuda(packed, 'packed', (b, c), torch.int32),
            check_cuda(wb, 'w', (c * NCH, ldw), torch.bfloat16)]
    out = torch.empty((b, h), dtype=torch.bfloat16, device=packed.device)
    if b == 0:
        return out
    with torch.cuda.device(packed.device):
        err = _lib_fn('mgt_onehot_linear_launch', 3, 4)(
            *ptrs, out.data_ptr(), b, c, h, ldw, _stream(packed.device))
    if err != 0:
        raise RuntimeError(f'onehot_linear kernel launch failed: CUDA error {err}')
    launches += 1
    return out


def grad_w_cuda(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the gradient kernel on CUDA tensors (no count): (C·21, H) f32.
    ``g`` must be bf16 already."""
    h = g.shape[-1]
    b, c = _check_shapes(packed, h)
    if h not in GRAD_HIDDEN:
        raise ValueError(f'the gradient kernel takes {GRAD_HIDDEN} columns, got {h}')
    dev = packed.device
    ptrs = [check_cuda(packed, 'packed', (b, c), torch.int32),
            check_cuda(g, 'g', (b, h), torch.bfloat16)]
    out = torch.zeros((c * NCH, h), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    # Split the batch so the blocks (row tiles x chunks) fill the card twice
    # over, with chunks of at least 256 samples.
    tiles = -(-c // GRAD_CELLS_PER_BLOCK)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, min(-(-b // 256), -(-2 * sms // tiles)))
    partial = torch.empty((chunks if chunks > 1 else 0, c * NCH, h),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib_fn('mgt_onehot_grad_launch', 4, 4)(
            *ptrs, partial.data_ptr(), out.data_ptr(), b, c, h, chunks, _stream(dev))
    if err != 0:
        raise RuntimeError(f'onehot_linear gradient kernel launch failed: error {err}')
    return out


def onehot_linear_grad_w(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``one_hot(packed)ᵀ @ bf16(g)`` → (C·21, H) float32: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global grad_launches
    if packed.device.type == 'cpu':
        return onehot_linear_grad_w_plain(packed, g)
    out = grad_w_cuda(packed, g.to(torch.bfloat16).contiguous())
    grad_launches += 1
    return out


class _OneHotLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, packed, w):
        ctx.save_for_backward(packed)
        return onehot_linear_forward(packed, w)

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        dw = onehot_linear_grad_w(packed, g) if ctx.needs_input_grad[1] else None
        return None, dw


def onehot_linear(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``one_hot(packed) @ w`` → (B, H) bf16 from (B, C)
    int32 packed cells and (C·21, H) float32 weights. Its backward is the
    gradient kernel; ``packed`` (integer data) has no gradient."""
    return _OneHotLinear.apply(packed, w)
