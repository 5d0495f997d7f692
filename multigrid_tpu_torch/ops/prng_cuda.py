"""Keyed random draws through the hand-written CUDA kernels.

``csrc/prng.cu`` holds two kernels, neither with a Pallas counterpart (XLA
computes threefry2x32 inline in the JAX package):

* R1, ``threefry_bits_kernel`` (:func:`draw`): a batched draw, keys by a
  range of flat indices, written as key pairs, bits, uniform floats, Gumbel
  noise or randint; every ``utils/prng.py`` function on the card is one
  launch of it. With ``split_first`` the launch also splits each key first
  (``k', sub = split(k)``, the draw from ``sub``): the path's ``split`` and
  the draw that uses it are one launch.
* R2, ``step_draws_kernel`` (:func:`step_draws`): each env's step draws in
  one launch: the split of its key, its agents' order and the auto-reset's
  fresh keys; teams of up to 8 agents take an instance unrolled for their
  size.

What bounds them on the card is the launch and each thread's chain of
dependent hashes, not bytes: at the port's sizes their bound by bytes or
operations is under a microsecond, below the cost of any launch. Their
yardstick is the launch floor, an empty kernel launched the same way
(``mgt_launch_floor``, timed by ``chip_smoke.py``). The design cuts
launches (the split in the draw's launch) and the chain (R1 one element a
thread, three hashes deep for a split-first randint; R2's per-env hashes
as independent chains in registers, three deep).

Each is bit-equal to its plain version in :mod:`multigrid_tpu_torch.utils.prng`
(``draw_plain``, ``step_draws_plain``), which runs for tensors on the CPU;
these wrappers launch the kernel on CUDA tensors or raise. The library is
built from the package's sources at first use (:mod:`~multigrid_tpu_torch.utils.build`);
this module imports without a CUDA toolkit.
"""

from __future__ import annotations

import torch

from ..utils import prng

SOURCE = 'prng.cu'

#: Launches of R1 and of R2 since the counts were last set to 0; nothing
#: else adds to them.
launches = 0
step_launches = 0

_fns: dict = {}


def _lib(name: str):
    if name not in _fns:
        import ctypes

        from ..utils import build
        fn = getattr(build.load(SOURCE), name)
        if name == 'mgt_threefry_launch':
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 3)
        elif name == 'mgt_launch_floor':
            fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        else:
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _keys(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.device.type != 'cuda' or t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != 2:
        raise ValueError(f'{name}: the kernel needs an int64 CUDA tensor of shape (K, 2), '
                         f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    return t.contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def draw(keys: torch.Tensor, count: int, offset, mode: int, *, spans=None, minval: int = 0,
         fmin: float = 0.0, fmax: float = 1.0, split_first: bool = False):
    """R1: ``count`` elements from each key of ``keys`` (K, 2) at flat
    indices from ``offset`` (an int, or a 0-d int64 tensor on the keys'
    device, read there), one launch on the current stream, as
    :func:`multigrid_tpu_torch.utils.prng.draw_plain` computes them; with
    ``split_first``, ``(k', draw)``: each key split first in the same
    launch, the draw from element 1, element 0 returned (K, 2). No host
    synchronization: a CUDA graph captures it."""
    global launches
    keys = _keys(keys, 'keys')
    dev, k = keys.device, keys.shape[0]
    dtype = {prng.PAIR: torch.int64, prng.BITS: torch.int64, prng.UNIFORM: torch.float32,
             prng.GUMBEL: torch.float32, prng.RANDINT: torch.int32}[mode]
    out = torch.empty((k, count) + ((2,) if mode == prng.PAIR else ()), dtype=dtype, device=dev)
    carried = torch.empty_like(keys) if split_first else None
    offset_dev = None
    if isinstance(offset, torch.Tensor):
        offset_dev = offset.to(device=dev, dtype=torch.int64).reshape(()).contiguous()
        offset = 0
    span_len, spans_ptr = 1, None
    if mode == prng.RANDINT:
        spans = torch.as_tensor(spans, dtype=torch.int64, device=dev).contiguous()
        span_len, spans_ptr = spans.numel(), spans.data_ptr()
    if k > 0 and (count > 0 or split_first):
        with torch.cuda.device(dev):
            err = _lib('mgt_threefry_launch')(
                keys.data_ptr(), k, count, int(offset),
                None if offset_dev is None else offset_dev.data_ptr(), mode, spans_ptr,
                span_len, int(minval), float(fmin), float(fmax), out.data_ptr(),
                None if carried is None else carried.data_ptr(), _stream(dev))
        if err != 0:
            raise RuntimeError(f'threefry draw kernel launch failed: CUDA error {err}')
        launches += 1
    return out if carried is None else (carried, out)


def step_draws(rng: torch.Tensor, num_agents: int, mode: int = prng.STEP_ONLY):
    """R2: each env's step draws from its key (E, 2), one launch on the
    current stream; ``(order (E, N) int32, rng', gen_key or None, fresh rng
    or None)`` as :func:`multigrid_tpu_torch.utils.prng.step_draws_plain`
    gives them."""
    global step_launches
    rng = _keys(rng, 'rng')
    if not 1 <= num_agents <= prng.MAX_STEP_AGENTS:
        raise ValueError(f'step draws rank 1 to {prng.MAX_STEP_AGENTS} agents, '
                         f'not {num_agents}')
    dev, e = rng.device, rng.shape[0]
    order = torch.empty((e, num_agents), dtype=torch.int32, device=dev)
    new = torch.empty_like(rng)
    gen = torch.empty_like(rng) if mode == prng.STEP_EXACT else None
    fresh = torch.empty_like(rng) if mode != prng.STEP_ONLY else None
    if e > 0:
        with torch.cuda.device(dev):
            err = _lib('mgt_step_draws_launch')(
                rng.data_ptr(), e, num_agents, mode, order.data_ptr(), new.data_ptr(),
                None if gen is None else gen.data_ptr(),
                None if fresh is None else fresh.data_ptr(), _stream(dev))
        if err != 0:
            raise RuntimeError(f'step draws kernel launch failed: CUDA error {err}')
        step_launches += 1
    return order, new, gen, fresh
