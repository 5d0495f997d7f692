"""Keyed random draws: the slice of ``jax.random`` the JAX package uses.

The JAX package keeps a threefry2x32 key per env in its state and makes
every draw from keys (multigrid_tpu/core/state.py:65). With JAX 0.9's
``jax_threefry_partitionable``, ``split``, ``fold_in`` and ``random_bits``
hash the key with each element's flat index in the draw's shape
(jax/_src/prng.py:1156-1200), so any rows of a draw are computed alone:
this module's ``rows=(start, stop)`` (or a slice, as ``VectorEnv.rows``)
draws rows ``start..stop`` of the leading axis of a global draw, bit-equal to those rows of the whole draw,
which is how each process of a mesh makes only its own envs' draws.

A key is two uint32 words held in an int64 tensor of shape ``(..., 2)``:
every function takes a leading batch of keys (as the JAX package ``vmap``s
them) and returns the batch's axes, then the draw's. The values are
bit-equal to ``jax.random``'s for the same key (``jax.random.key_data``),
Gumbel noise up to the ``log`` (XLA's and PyTorch's may differ by an ulp).

Every batched draw takes ``split_first=True``: the keys are split first,
the draw is made from element 1 of each split and element 0 comes back
beside it, ``(k', draw)``, as ``k', sub = split(k)`` then the draw from
``sub`` gives them. That is the key chain's step (``key, sub =
split(key)``, then a draw from ``sub``), in one launch on the card.

On the card every draw is one launch of a hand-written kernel
(:mod:`~multigrid_tpu_torch.ops.prng_cuda`: R1, ``threefry_bits_kernel``,
and R2, ``step_draws_kernel``); on the CPU the plain versions here compute
the same bits with int64 tensor ops masked to 32 bits. A tensor on the card
never takes the plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import constant

MASK = 0xFFFFFFFF

#: ``mode`` of a batched draw (csrc/prng_core.cuh::Mode).
PAIR, BITS, UNIFORM, GUMBEL, RANDINT = range(5)
#: ``mode`` of the step draws (csrc/prng_core.cuh::StepMode).
STEP_ONLY, STEP_EXACT, STEP_POOL = range(3)
#: The most agents the step draws rank (csrc/prng_core.cuh::kMaxStepAgents).
MAX_STEP_AGENTS = 64

TINY = float(np.finfo(np.float32).tiny)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device: str | torch.device = 'cpu') -> torch.Tensor:
    """The key of an integer seed, ``jax.random.key_data(jax.random.key(seed))``:
    ``[seed >> 32, seed & 0xFFFFFFFF]`` (prng.py:802-829); a seed in the
    int32 range has a high word of 0."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def as_key(key_or_seed, device: str | torch.device) -> torch.Tensor:
    """A key tensor on ``device`` from a key (any integer dtype, uint32
    words) or an int seed."""
    if isinstance(key_or_seed, (int, np.integer)):
        return key(int(key_or_seed), device)
    k = torch.as_tensor(np.asarray(key_or_seed).astype(np.int64)
                        if not isinstance(key_or_seed, torch.Tensor) else key_or_seed)
    if k.shape[-1:] != (2,):
        raise ValueError(f'a key has two words in its last axis, got shape {tuple(k.shape)}')
    return (k.to(device=device, dtype=torch.int64) & MASK)


def key_data(keys: torch.Tensor) -> np.ndarray:
    """The keys as a uint32 numpy array, ``jax.random.key_data``'s layout."""
    return keys.cpu().numpy().astype(np.uint32)


# --------------------------------------------------------------- plain versions


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32-20 on int64 tensors holding uint32 values, broadcast
    (prng.py::_threefry2x32_lowering): the keys ``(k0, k1)`` hash the counts
    ``(x0, x1)``; returns the two words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i, (a, b) in enumerate(((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & MASK
        x1 = (x1 + b + (i + 1)) & MASK
    return x0, x1


def _pair(k0, k1, index):
    """Both words of the keys' hash of flat ``index`` (int64)."""
    return threefry2x32(k0, k1, index >> 32, index & MASK)


def _bits(k0, k1, index):
    y0, y1 = _pair(k0, k1, index)
    return y0 ^ y1


def _unit(b: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from bits: 23 mantissa bits of a float in [1, 2), less 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _uniform(b: torch.Tensor, fmin: float, fmax: float) -> torch.Tensor:
    """``floats · (maxval − minval) + minval`` rounded once, as XLA fuses it
    into a multiply-add: the product of two float32 values is exact in
    float64, and the sum is rounded to float64, then to float32 (the double
    rounding can differ from a fused multiply-add only where the float64
    sum lands on a float32 tie, and never for the bounds the package draws:
    [0, 1) and [tiny, 1)); then at least ``minval``."""
    lo, span = np.float32(fmin), np.float32(fmax) - np.float32(fmin)
    x = (_unit(b).double() * float(span) + float(lo)).float()
    return torch.clamp_min(x, float(lo))



def _randint(k0, k1, index, span, minval: int) -> torch.Tensor:
    span = torch.where(span == 0, 1, span)
    zero = torch.zeros_like(k0)
    a0, a1 = _pair(k0, k1, zero)
    b0, b1 = _pair(k0, k1, zero + 1)
    hi, lo = _bits(a0, a1, index), _bits(b0, b1, index)
    # uint32 arithmetic, as JAX's: every sum and product keeps its low word
    # (a product past 2**63 wraps in int64, and its low word is right).
    mult = (((65536 % span) ** 2) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK

    return (off % span + minval).to(torch.int32)


def draw_plain(keys: torch.Tensor, count: int, offset, mode: int, *, spans=None,
               minval: int = 0, fmin: float = 0.0, fmax: float = 1.0,
               split_first: bool = False):
    """R1's plain version: keys (K, 2) draw ``count`` elements each, from
    flat index ``offset`` (an int, or a 0-d int64 tensor); (K, count, 2)
    int64 for :data:`PAIR`, (K, count) int64, float32 or int32 for the
    others. ``spans`` (randint) holds a span for each position of the
    draw's last axis. With ``split_first``, ``(k', draw)``: the plain split
    of each key, then the plain draw from its element 1; element 0 is
    ``k'`` (K, 2)."""
    if split_first:
        pair = draw_plain(keys, 2, 0, PAIR)
        return pair[:, 0], draw_plain(pair[:, 1], count, offset, mode, spans=spans,
                                      minval=minval, fmin=fmin, fmax=fmax)
    dev = keys.device
    index = torch.arange(count, dtype=torch.int64, device=dev) + offset
    k0, k1 = keys[:, :1], keys[:, 1:]
    index = index[None, :]
    if mode == PAIR:
        y0, y1 = _pair(k0, k1, index)
        return torch.stack([y0, y1], -1)
    if mode == RANDINT:
        s = torch.as_tensor(spans, dtype=torch.int64, device=dev)
        return _randint(k0, k1, index, s[index % s.numel()], minval)
    b = _bits(k0, k1, index)
    if mode == BITS:
        return b
    if mode == UNIFORM:
        return _uniform(b, fmin, fmax)
    if mode == GUMBEL:
        return -torch.log(-torch.log(_uniform(b, TINY, 1.0)))
    raise ValueError(f'unknown draw mode {mode}')


def step_draws_plain(rng: torch.Tensor, num_agents: int, mode: int = STEP_ONLY):
    """R2's plain version: for each env's key (E, 2), ``order_key, rng' =
    split(rng)``, the order ``argsort(uniform(order_key, (N,)))`` (stable,
    int32, ``(0,)`` for one agent, JAX ops/step.py:363-371), then, by
    ``mode``, ``split(fold_in(rng', 0))`` (the exact reset's ``gen_key``
    and ``rng``) or ``fold_in(rng', 1)`` (the pool's fresh ``rng``).
    Returns ``(order, rng', gen_key or None, fresh rng or None)``."""
    e = rng.shape[0]
    k0, k1 = rng[:, :1], rng[:, 1:]
    zero = torch.zeros((1, 1), dtype=torch.int64, device=rng.device)
    o0, o1 = _pair(k0, k1, zero)
    r0, r1 = _pair(k0, k1, zero + 1)
    if num_agents == 1:
        order = torch.zeros((e, 1), dtype=torch.int32, device=rng.device)
    else:
        index = torch.arange(num_agents, dtype=torch.int64, device=rng.device)[None]
        u = _uniform(_bits(o0, o1, index), 0.0, 1.0)
        order = torch.argsort(u, dim=-1, stable=True).to(torch.int32)
    new = torch.cat([r0, r1], -1)
    gen = fresh = None
    if mode == STEP_EXACT:
        f0, f1 = _pair(r0, r1, zero)
        gen = torch.cat(_pair(f0, f1, zero), -1)
        fresh = torch.cat(_pair(f0, f1, zero + 1), -1)
    elif mode == STEP_POOL:
        fresh = torch.cat(_pair(r0, r1, zero + 1), -1)
    return order, new, gen, fresh


# ------------------------------------------------------------------- dispatch


def _draw(keys: torch.Tensor, count: int, offset, mode: int, **kw):
    """R1 on the card, its plain version on the CPU."""
    return draw_plain(keys, count, offset, mode, **kw)


def step_draws(rng: torch.Tensor, num_agents: int, mode: int = STEP_ONLY):
    """Every env's step draws (:func:`step_draws_plain`): R2 on the card,
    one launch, its plain version on the CPU."""
    return step_draws_plain(rng, num_agents, mode)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _batched(keys: torch.Tensor, shape, rows, mode: int, split_first: bool = False, **kw):
    """A draw of ``shape`` (its rows ``rows`` of the leading axis) from
    each key of the batch ``keys`` (..., 2): (..., *local shape[, 2]); with
    ``split_first``, ``(k', draw)`` (module docstring), ``k'`` shaped as
    ``keys``."""
    shape = _shape(shape)
    batch = keys.shape[:-1]
    flat = keys.reshape(-1, 2).contiguous()
    inner = math.prod(shape[1:])
    if rows is None:
        local, offset = shape, 0
    else:
        start, stop = (rows.start, rows.stop) if isinstance(rows, slice) else rows
        if not shape or not 0 <= start <= stop <= shape[0]:
            raise ValueError(f'rows {rows} outside the draw of shape {shape}')
        local, offset = (stop - start,) + shape[1:], start * inner
    out = _draw(flat, math.prod(local), offset, mode, split_first=split_first, **kw)
    if split_first:
        carried, out = out
    out = out.reshape(batch + local + ((2,) if mode == PAIR else ()))
    return (carried.reshape(keys.shape), out) if split_first else out


def split(keys: torch.Tensor, num=2, *, rows=None, split_first: bool = False):
    """``jax.random.split``: ``num`` (an int or a shape) new keys from each
    key: (..., *num, 2)."""
    return _batched(keys, num, rows, PAIR, split_first)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for each key; ``data`` an int or a
    0-d integer tensor on the keys' device (read there: a graph holds it)."""
    if isinstance(data, torch.Tensor):
        offset = data.to(torch.int64)
    else:
        offset = int(data) & MASK
    return _draw(keys.reshape(-1, 2).contiguous(), 1, offset, PAIR).reshape(keys.shape)


def bits(keys: torch.Tensor, shape, *, rows=None, split_first: bool = False):
    """``jax.random.bits`` (uint32 values in int64): (..., *shape)."""
    return _batched(keys, shape, rows, BITS, split_first)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0, *,
            rows=None, split_first: bool = False):
    """``jax.random.uniform`` in float32: (..., *shape)."""
    return _batched(keys, shape, rows, UNIFORM, split_first, fmin=float(minval),
                    fmax=float(maxval))


def gumbel(keys: torch.Tensor, shape=(), *, rows=None, split_first: bool = False):
    """``jax.random.gumbel`` (float32, mode ``'low'``): (..., *shape)."""
    return _batched(keys, shape, rows, GUMBEL, split_first)


def randint(keys: torch.Tensor, shape, minval: int, maxval, *, rows=None,
            split_first: bool = False):
    """``jax.random.randint`` with int32 values in ``[minval, maxval)``
    (random.py:581): (..., *shape). ``maxval`` is an int or a sequence with
    one bound for each position of the draw's last axis (broadcast as JAX
    broadcasts it); a bound at most ``minval`` draws ``minval``."""
    shape = _shape(shape)
    hi = np.asarray(maxval, dtype=np.int64).reshape(-1)
    if hi.size != 1 and (not shape or hi.size != shape[-1]):
        raise ValueError(f'maxval {maxval} does not broadcast to the last axis of {shape}')
    spans = np.where(hi > minval, (hi - minval) & MASK, 0)
    return _batched(keys, shape, rows, RANDINT, split_first,
                    spans=constant(spans, keys.device), minval=int(minval))


def categorical(keys: torch.Tensor, logits: torch.Tensor, *, rows=None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the Gumbel-max sample
    ``argmax(gumbel(key, shape) + logits)`` (first index on ties), int32.
    With ``rows``, ``logits`` holds those rows of the global draw's."""
    shape = tuple(logits.shape)
    if rows is not None:
        stop = rows.stop if isinstance(rows, slice) else rows[1]
        shape = (int(stop),) + shape[1:]
    g = gumbel(keys, shape, rows=rows)
    return (g + logits).argmax(dim=-1).to(torch.int32)


def permutation(keys: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation`` of ``arange(x)`` (an int) or of a 1-D
    tensor, for each key (random.py:700-729): rounds of a stable sort by
    fresh 32-bit keys, ``ceil(3 ln(n) / ln(2**32 - 1))`` of them, each
    round's ``keys, sub = split(keys)`` and the bits of ``sub`` one draw:
    (..., n)."""
    if isinstance(x, (int, np.integer)):
        x = torch.arange(int(x), device=keys.device)
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    out = x.expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        keys, sort_keys = bits(keys, (n,), split_first=True)
        idx = torch.sort(sort_keys, dim=-1, stable=True).indices
        out = out.gather(-1, idx)
    return out


__all__ = ['BITS', 'GUMBEL', 'MASK', 'PAIR', 'RANDINT', 'STEP_EXACT', 'STEP_ONLY', 'STEP_POOL',
           'UNIFORM', 'as_key', 'bits', 'categorical', 'draw_plain', 'fold_in', 'gumbel', 'key',
           'key_data', 'permutation', 'randint', 'split', 'step_draws', 'step_draws_plain',
           'threefry2x32', 'uniform']
