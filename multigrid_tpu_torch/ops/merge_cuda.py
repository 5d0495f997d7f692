"""The auto-reset's consume and merge through the hand-written CUDA kernel.

Counterpart of the JAX package's reset-on-done
(``multigrid_tpu/parallel/vector.py:392-411``: every env's fresh layout,
then a select of every field), whose plain version here is
``VectorEnv.consume`` (or the exact reset) and
:func:`~multigrid_tpu_torch.core.state.where_state`. ``csrc/merge.cu`` (M1)
does both in one launch: it writes the fresh episode's rows into the
stepped states in place, only for the envs that finished, reading them
from the packed reserve at each env's slot (``(i + g) mod slots``, the
cells unpacked inline), from a window of it (under a mesh) or from an
exact reset, and the fresh keys from the step's draws. It is bit-equal to
the plain version, which ``VectorEnv.reset_done`` keeps for tensors on the
CPU.

:func:`plan` is the host side: one :class:`Field` for every destination
tensor, its kind and source, and the aliasing decisions. A destination is
written in place only where the step made it: a tensor that shares memory
with the step's input state (a field the step passed through untouched),
with a tensor the step returns (its terminations are the stepped
``agent_terminated``), with the fresh source, or with another destination
in another view, is replaced by a new tensor that M1 fills for every env (the fresh row where
done, the old row elsewhere), so the caller's state is never written. A
destination that ``obs_state`` and ``new_state`` share is written once.
Inside a CUDA graph these decisions are made at the capture, from the
tensors' addresses, and the graph replays them.

The library is built from the package's sources at first use (see
:mod:`multigrid_tpu_torch.utils.build`); this module imports without a CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..core.state import STATE_FIELDS, MultiGridState

SOURCE = 'merge.cu'

#: Launches of M1 since the count was last set to 0; nothing else adds to it.
launches = 0

#: A field's kinds (``csrc/merge.cu::Kind``): a row copied from the env's
#: slot (or from the env, without a pool step), a row copied from the env's
#: own (the fresh keys), and a packed reserve row unpacked.
COPY, KEY, UNPACK = 0, 1, 2

#: Fields one launch takes (``csrc/merge.cu::kMaxFields``).
MAX_FIELDS = 48


class _Field(ctypes.Structure):
    """``csrc/merge.cu::Field``."""
    _fields_ = [('src', ctypes.c_void_p), ('keep', ctypes.c_void_p), ('dst', ctypes.c_void_p),
                ('src_stride', ctypes.c_longlong), ('keep_stride', ctypes.c_longlong),
                ('bytes', ctypes.c_int), ('kind', ctypes.c_int), ('shift', ctypes.c_int),
                ('unit', ctypes.c_int)]


@dataclasses.dataclass
class Field:
    """One destination tensor of M1: ``name`` the state's field (an extra as
    ``extras.<key>``), ``kind`` :data:`COPY`, :data:`KEY` or :data:`UNPACK`
    (``shift`` the bit of the packed cell's lowest lane: 0 the grid, 12 a
    Box's contents), ``src`` the fresh rows, ``dst`` the rows written and
    ``keep`` None where ``dst`` is written in place, else the rows each
    running env keeps (``dst`` is then a new tensor)."""

    name: str
    kind: int
    src: torch.Tensor
    dst: torch.Tensor
    keep: torch.Tensor | None = None
    shift: int = 0

    @property
    def row_bytes(self) -> int:
        return math.prod(self.dst.shape[1:]) * self.dst.element_size()


def state_tensors(state: MultiGridState) -> list[torch.Tensor]:
    """Every tensor a state holds: its fields, its extras and its pool's."""
    out = [getattr(state, f) for f in STATE_FIELDS] + list(state.extras.values())
    pool = state.pool
    if pool is not None:
        out += state_tensors(pool.reserve) + [pool.step] + (
            [] if pool.keys is None else [pool.keys])
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr(), a.shape, a.stride(), a.dtype) == (b.data_ptr(), b.shape, b.stride(),
                                                            b.dtype)


def _sources(name: str, source: MultiGridState, fresh_rng: torch.Tensor, packed: bool):
    """``(kind, rows, shift)`` of the field ``name``'s fresh rows."""
    if name == 'rng':
        return KEY, fresh_rng, 0
    if packed and name in ('grid', 'box_contents'):
        return UNPACK, source.grid, 0 if name == 'grid' else 12
    if name.startswith('extras.'):
        return COPY, source.extras[name[len('extras.'):]], 0
    return COPY, getattr(source, name), 0


def _check(f: Field, rows: int) -> None:
    src, dst = f.src, f.dst
    if f.kind == UNPACK:
        ok = (src.dtype == dst.dtype == torch.int32 and src.dim() == 2 and dst.dim() == 4
              and dst.shape[3] == 3 and src.shape[1] == dst.shape[1] * dst.shape[2])
    else:
        ok = src.dtype == dst.dtype and src.shape[1:] == dst.shape[1:]
    if not ok or src.shape[0] != rows or src.device != dst.device:
        raise ValueError(
            f'reset merge: {f.name}: fresh rows {src.dtype} {tuple(src.shape)} on {src.device} '
            f'do not fit {dst.dtype} {tuple(dst.shape)} on {dst.device} ({rows} source rows)')


def plan(done: torch.Tensor, obs_state: MultiGridState, new_state: MultiGridState,
         source: MultiGridState, fresh_rng: torch.Tensor, *, slots: int | None = None,
         packed: bool = False, inputs: list[torch.Tensor]):
    """M1's fields, and the two states it leaves: ``(fields, obs_state,
    new_state)``. ``source`` holds the fresh layouts (packed where
    ``packed``: ``grid`` (slots, W·H)), one a slot where ``slots`` is given
    (the reserve, read at ``(i + g) mod slots``), else one an env;
    ``fresh_rng`` (E, 2) the fresh keys. No tensor that shares memory with
    one of ``inputs`` (the step's input state and the tensors it returns)
    is written in place. Raises ValueError where the
    extras differ or a source does not fit its destination."""
    if obs_state.extras.keys() != new_state.extras.keys() \
            or source.extras.keys() != new_state.extras.keys():
        raise ValueError(f'extras differ: {sorted(source.extras)}, {sorted(obs_state.extras)} '
                         f'and {sorted(new_state.extras)}')
    e = done.shape[0]
    protected = {_storage(t) for t in inputs + state_tensors(source) + [fresh_rng] if t.numel()}
    names = list(STATE_FIELDS) + [f'extras.{k}' for k in sorted(new_state.extras)]
    states = [new_state] if obs_state is new_state else [new_state, obs_state]

    def get(state, name):
        return state.extras[name[7:]] if name.startswith('extras.') else getattr(state, name)
    # The distinct views of each destination's memory: one written in
    # place must be the only one.
    views: dict[int, list[torch.Tensor]] = {}
    for name in names:
        for state in states:
            dst = get(state, name)
            if dst.numel():
                same = views.setdefault(_storage(dst), [])
                if not any(_same_view(v, dst) for v in same):
                    same.append(dst)
    results = [{} for _ in states]
    fields: list[Field] = []
    seen: list[tuple[torch.Tensor, torch.Tensor]] = []  # (destination, tensor written)
    for name in names:
        kind, src, shift = _sources(name, source, fresh_rng, packed)
        for state, result in zip(states, results):
            dst = get(state, name)
            if dst.numel() == 0:
                continue
            out = next((o for d, o in seen if _same_view(d, dst)), None)
            if out is None:
                in_place = dst.is_contiguous() and _storage(dst) not in protected \
                    and len(views[_storage(dst)]) == 1
                out = dst if in_place else torch.empty(dst.shape, dtype=dst.dtype,
                                                       device=dst.device)
                f = Field(name, kind, src, out, None if in_place else dst, shift)
                _check(f, e if kind == KEY or slots is None else slots)
                fields.append(f)
                seen.append((dst, out))
            result[name] = out
    out_states = []
    for state, result in zip(states, results):
        extras = {k: result.get(f'extras.{k}', v) for k, v in state.extras.items()}
        out_states.append(state.replace(
            **{f: result[f] for f in STATE_FIELDS if f in result}, extras=extras))
    return fields, out_states[-1], out_states[0]


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` with contiguous rows, and the bytes between them (0 where every
    row is the same: a broadcast view keeps one)."""
    if t.shape[0] and not t[0].is_contiguous():
        t = t[:1].contiguous().expand(t.shape) if t.stride(0) == 0 else t.contiguous()
    return t, t.stride(0) * t.element_size()


def table(fields: list[Field]):
    """The launch's table (a ctypes array of ``csrc/merge.cu::Field``) and
    the tensors it points into, which must live until the launch."""
    if len(fields) > MAX_FIELDS:
        raise ValueError(f'reset merge takes at most {MAX_FIELDS} fields, not {len(fields)}')
    rows = (_Field * max(1, len(fields)))()
    alive = []
    for row, f in zip(rows, fields):
        src, src_stride = _rows(f.src)
        keep, keep_stride = _rows(f.keep) if f.keep is not None else (None, 0)
        alive += [src, keep]
        row.src, row.dst, row.src_stride = src.data_ptr(), f.dst.data_ptr(), src_stride
        row.keep = None if keep is None else keep.data_ptr()
        row.keep_stride, row.bytes, row.kind, row.shift = keep_stride, f.row_bytes, f.kind, \
            f.shift
        # The widest copy (16-byte vectors, int32 words, bytes) that every
        # address and size allows.
        sizes = [row.src, row.dst, src_stride, keep_stride, row.bytes, row.keep or 0]
        row.unit = next(u for u in (16, 4, 1) if all(a % u == 0 for a in sizes))
    return rows, alive


_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        from ..utils import build
        lib = build.load(SOURCE)
        info = lib.mgt_reset_merge_info
        info.argtypes = [ctypes.c_void_p]
        info.restype = ctypes.c_int
        out = (ctypes.c_longlong * 3)()
        info(out)
        if (out[0], out[1]) != (MAX_FIELDS, ctypes.sizeof(_Field)):
            raise RuntimeError(f'merge.cu takes {out[0]} fields of {out[1]} bytes; the wrapper '
                               f'{MAX_FIELDS} of {ctypes.sizeof(_Field)}')
        fn = lib.mgt_reset_merge_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_merge(done: torch.Tensor, obs_state: MultiGridState, new_state: MultiGridState,
                source: MultiGridState, fresh_rng: torch.Tensor, *,
                inputs: list[torch.Tensor], step: torch.Tensor | None = None,
                packed: bool = False):
    """``(obs_state, new_state)`` with every finished env's fresh episode
    (``done`` (E,) bool), from one launch of M1 on the current stream, as
    :func:`plan` lays it out (``step``: the pool's global step, a 0-d int64
    device tensor; the source's rows are then its slots). Raises ValueError
    for tensors the kernel does not take. No host synchronization: a CUDA
    graph captures it."""
    global launches
    dev = done.device
    if dev.type != 'cuda' or done.dtype != torch.bool or done.dim() != 1 \
            or not done.is_contiguous():
        raise ValueError(f'reset merge needs a contiguous (E,) bool CUDA done, got {done.dtype} '
                         f'{tuple(done.shape)} on {dev}')
    if step is not None and (step.device != dev or step.dtype != torch.int64 or step.dim()):
        raise ValueError(f'reset merge needs the pool step as a 0-d int64 tensor on {dev}')
    slots = None if step is None else source.grid.shape[0]
    fields, obs_state, new_state = plan(done, obs_state, new_state, source, fresh_rng,
                                        slots=slots, packed=packed, inputs=inputs)
    rows, alive = table(fields)
    e = done.shape[0]
    if e > 0 and fields:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib_fn()(rows, len(fields), done.data_ptr(),
                            None if step is None else step.data_ptr(), e, slots or 0, stream)
        if err != 0:
            raise RuntimeError(f'reset merge kernel launch failed: CUDA error {err}')
        launches += 1
    del alive
    return obs_state, new_state
