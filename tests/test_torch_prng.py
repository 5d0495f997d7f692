"""``multigrid_tpu_torch/utils/prng.py`` ≡ ``jax.random``, on the CPU.

With JAX's partitionable threefry (JAX 0.9's default) every draw hashes the
key with each element's flat index, so the port's plain versions compute
the same bits: ``key``, ``split``, ``fold_in``, ``bits``, ``uniform``,
``randint`` (two draws combined modulo the span, spans that are no powers
of 2 included), ``categorical`` and ``permutation`` are bit-equal for keys,
shapes, spans and ``rows=`` drawn by hypothesis; Gumbel noise is held
within 4 ulps of ``max(|g|, 1)`` (``torch.log`` and XLA's ``log`` differ
by an ulp now and then: 2 ulps at most over 6 million draws), and the
actions it samples are bit-equal. A process's ``rows=`` equal that slice
of the global draw. The step draws (the order as a stable argsort, ties
included, and the auto-reset's keys) and the learner's draws (a rollout's
actions, an update's minibatch shuffles) are the JAX package's.

The kernels' per-element code, ``csrc/prng_core.cuh``, is built here with
g++ into a host library and held bit-equal to the plain versions (Gumbel
noise to the same ulp bound: glibc's ``logf`` is not torch's ``log``): R1's
grid-stride walk over emulated grids, with and without its split prologue,
and R2's unrolled bodies (teams of 1 to 8) and generic body; the CUDA
kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``prng`` phase). A draw
with ``split_first`` is the split followed by the draw, in every mode.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multigrid_tpu_torch import VectorEnv, make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.utils import prng
from multigrid_tpu_torch.utils.build import CSRC_DIR

torch.set_num_threads(1)

SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 4), (7, 2)]
GUMBEL_ULPS = 4
WORDS = st.integers(0, 2**32 - 1)
SETTINGS = settings(max_examples=25, deadline=None, derandomize=True, database=None)


def jkey(words) -> jax.Array:
    return jax.random.wrap_key_data(np.asarray(words, dtype=np.uint32))


def tkey(words) -> torch.Tensor:
    return torch.tensor(list(words), dtype=torch.int64)


def data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys))


def assert_gumbel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= GUMBEL_ULPS * scale).all()


@pytest.mark.parametrize('seed', [0, 1, 42, 2**31 - 1, -1, -2**31])
def test_key_is_jax_key(seed):
    np.testing.assert_array_equal(prng.key_data(prng.key(seed)),
                                  data(jax.random.key(seed)))


@SETTINGS
@given(WORDS, WORDS, st.sampled_from(SHAPES), st.integers(0, 2**31 - 1))
def test_split_fold_in_and_bits_are_jax(k0, k1, shape, folded):
    jk, tk = jkey([k0, k1]), tkey([k0, k1])
    np.testing.assert_array_equal(prng.key_data(prng.split(tk, shape)),
                                  data(jax.random.split(jk, shape)))
    np.testing.assert_array_equal(prng.key_data(prng.fold_in(tk, folded)),
                                  data(jax.random.fold_in(jk, folded)))
    np.testing.assert_array_equal(prng.key_data(prng.fold_in(tk, torch.tensor(folded))),
                                  data(jax.random.fold_in(jk, folded)))
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape)))


@SETTINGS
@given(WORDS, WORDS, st.sampled_from(SHAPES),
       st.sampled_from([(0.0, 1.0), (prng.TINY, 1.0), (-2.0, 3.0), (1.0, 1.5)]))
def test_uniform_is_jax(k0, k1, shape, bounds):
    got = prng.uniform(tkey([k0, k1]), shape, *bounds).numpy()
    want = np.asarray(jax.random.uniform(jkey([k0, k1]), shape, jnp.float32, *bounds))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@SETTINGS
@given(WORDS, WORDS, st.sampled_from(SHAPES),
       st.sampled_from([(0, 4), (0, 7), (1, 4), (0, 3), (-5, 8), (2, 1002), (0, 2**20 + 3),
                        (-2**31, 2**31 - 1), (3, 3), (5, 2)]))
def test_randint_is_jax(k0, k1, shape, bounds):
    lo, hi = bounds
    got = prng.randint(tkey([k0, k1]), shape, lo, hi)
    want = np.asarray(jax.random.randint(jkey([k0, k1]), shape, lo, hi, jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('shape', [(2,), (5, 2), (3, 2)])
def test_randint_with_a_bound_per_position_is_jax(shape):
    """A ``maxval`` sequence broadcast on the draw's last axis (a room's
    column and row, roomgrid.py:379 and playground.py:315)."""
    for s in range(8):
        got = prng.randint(prng.key(s), shape, 0, [3, 5])
        want = jax.random.randint(jax.random.key(s), shape, 0, jnp.asarray([3, 5]), jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@SETTINGS
@given(WORDS, WORDS, st.sampled_from(SHAPES[1:]))
def test_gumbel_is_jax_within_its_bound(k0, k1, shape):
    got = prng.gumbel(tkey([k0, k1]), shape).numpy()
    assert_gumbel_close(got, jax.random.gumbel(jkey([k0, k1]), shape))


@pytest.mark.parametrize('shape', [(64, 7), (16, 4, 7), (3, 2, 5)])
def test_categorical_is_jax(shape):
    """The Gumbel-max sample of JAX's ``categorical`` on numpy logits, bit
    for bit, and the same per process of its rows."""
    logits = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    for s in range(10):
        want = np.asarray(jax.random.categorical(jax.random.key(s), jnp.asarray(logits)))
        got = prng.categorical(prng.key(s), torch.as_tensor(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        half = shape[0] // 2
        part = prng.categorical(prng.key(s), torch.as_tensor(logits[half:]),
                                rows=(half, shape[0]))
        np.testing.assert_array_equal(part.numpy(), want[half:])


@SETTINGS
@given(WORDS, WORDS, st.sampled_from([1, 2, 6, 16, 128, 1000]))
def test_permutation_is_jax(k0, k1, n):
    """``permutation`` of ``arange(n)`` and of an array, one round of a
    stable sort by fresh bits (none for one element)."""
    np.testing.assert_array_equal(prng.permutation(tkey([k0, k1]), n).numpy(),
                                  np.asarray(jax.random.permutation(jkey([k0, k1]), n)))
    x = np.arange(n, dtype=np.int32) * 3 + 1
    np.testing.assert_array_equal(
        prng.permutation(tkey([k0, k1]), torch.as_tensor(x)).numpy(),
        np.asarray(jax.random.permutation(jkey([k0, k1]), jnp.asarray(x))))


def test_batched_keys_are_vmapped_draws():
    """A leading batch of keys draws as ``jax.vmap`` over the keys does."""
    keys = jax.random.split(jax.random.key(9), (3, 4))
    tk = torch.as_tensor(data(keys).astype(np.int64))
    np.testing.assert_array_equal(
        prng.key_data(prng.split(tk, 5)), data(jax.vmap(jax.vmap(
            lambda k: jax.random.split(k, 5)))(keys)))
    np.testing.assert_array_equal(
        prng.randint(tk, (6,), 0, 7).numpy(),
        np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (6,), 0, 7)))(keys)))
    np.testing.assert_array_equal(
        prng.permutation(tk, 9).numpy(),
        np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.permutation(k, 9)))(keys)))
    np.testing.assert_array_equal(
        prng.key_data(prng.fold_in(tk, 4)),
        data(jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 4)))(keys)))


@SETTINGS
@given(WORDS, WORDS, st.integers(0, 12), st.integers(0, 12),
       st.sampled_from([(12,), (12, 3), (12, 2, 4)]))
def test_rows_are_the_slice_of_the_global_draw(k0, k1, a, b, shape):
    start, stop = min(a, b), max(a, b)
    tk = tkey([k0, k1])
    for fn in (lambda s, r: prng.split(tk, s, rows=r), lambda s, r: prng.bits(tk, s, rows=r),
               lambda s, r: prng.uniform(tk, s, rows=r),
               lambda s, r: prng.randint(tk, s, 0, 7, rows=r),
               lambda s, r: prng.gumbel(tk, s, rows=r)):
        assert torch.equal(fn(shape, (start, stop)), fn(shape, None)[start:stop])
    with pytest.raises(ValueError):
        prng.bits(tk, shape, rows=(0, 13))


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('n', [1, 2, 4, 7])
def test_step_draws_are_the_jax_steps(mode, n):
    """``order_key, rng' = split(rng)``, the order the stable argsort of
    ``uniform(order_key, (N,))`` (JAX ops/step.py:363-371), then
    ``split(fold_in(rng', 0))`` or ``fold_in(rng', 1)``
    (vector.py:393-411, env.py:185-191)."""
    keys = jax.random.split(jax.random.key(n), 64)
    order, new, gen, fresh = prng.step_draws_plain(
        torch.as_tensor(data(keys).astype(np.int64)), n, mode)

    def one(k):
        order_key, rng = jax.random.split(k)
        o = jnp.zeros((1,), jnp.int32) if n == 1 else \
            jnp.argsort(jax.random.uniform(order_key, (n,))).astype(jnp.int32)
        g, f = jax.random.split(jax.random.fold_in(rng, 0))
        return o, rng, g, f, jax.random.fold_in(rng, 1)
    o, rng, g, f, p = jax.vmap(one)(keys)
    np.testing.assert_array_equal(order.numpy(), np.asarray(o))
    np.testing.assert_array_equal(prng.key_data(new), data(rng))
    assert (gen is None) == (mode != prng.STEP_EXACT)
    assert (fresh is None) == (mode == prng.STEP_ONLY)
    if mode == prng.STEP_EXACT:
        np.testing.assert_array_equal(prng.key_data(gen), data(g))
        np.testing.assert_array_equal(prng.key_data(fresh), data(f))
    elif mode == prng.STEP_POOL:
        np.testing.assert_array_equal(prng.key_data(fresh), data(p))


def test_step_order_ties_keep_index_order():
    """64 agents in 8192 envs: float32 uniforms tie in a few envs, and the
    order there is JAX's stable argsort."""
    keys = jax.random.split(jax.random.key(77), 8192)
    order, _, _, _ = prng.step_draws_plain(torch.as_tensor(data(keys).astype(np.int64)), 64)
    u = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (64,)))(keys)
    u = np.asarray(u)
    ties = [i for i in range(len(u)) if len(np.unique(u[i])) < 64]
    assert ties, 'no ties drawn'
    np.testing.assert_array_equal(order.numpy(), np.argsort(u, axis=-1, kind='stable'))


def test_learner_draws_are_the_jax_learners():
    """A rollout's actions are ``categorical(k_act, logits)`` for the keys
    ``key, k_act = split(key)`` of each step (ppo.py:397-400), and the
    update's shuffles are ``permutation(k_t, T)`` and ``randint(k_e, (), 0,
    E)`` of ``k_t, k_e = split(ek)`` for the epoch keys of ``split(k_perm,
    epochs)``, ``key, k_perm = split(key)`` after the rollout
    (ppo.py:667-675)."""
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 8,
                     packed_obs=True)
    cfg = ppo.PPOConfig(rollout_steps=4, epochs=3, minibatches=2)
    state, net, cfg, tx = ppo.ppo_init(venv, 3, config=cfg, hidden=32, dtype=torch.float32,
                                       net_kwargs=dict(encoder='mlp'))
    step = ppo.make_train_step(venv, net, cfg, tx)
    key = jkey(prng.key_data(state.key))
    _, traj, _, _ = step.rollout_phase(state)
    for t in range(cfg.rollout_steps):
        key, k_act = jax.random.split(key)
        logits, _ = step.policy(state.params, {'image': traj.image[t],
                                               'direction': traj.direction[t]})
        want = jax.random.categorical(k_act, jnp.asarray(logits.numpy()))
        np.testing.assert_array_equal(traj.action[t].numpy(), np.asarray(want))
    shuffles = []
    real = ppo.minibatches

    def spy(batch, count, perm_t, off_e, *a):
        shuffles.append((np.asarray(perm_t), int(off_e)))
        return real(batch, count, perm_t, off_e, *a)
    ppo.minibatches = spy
    try:
        after, _ = step(state)
    finally:
        ppo.minibatches = real
    key, k_perm = jax.random.split(key)
    for (perm, off), ek in zip(shuffles, jax.random.split(k_perm, cfg.epochs)):
        k_t, k_e = jax.random.split(ek)
        np.testing.assert_array_equal(perm, np.asarray(jax.random.permutation(k_t, 4)))
        assert off == int(jax.random.randint(k_e, (), 0, 8))
    assert len(shuffles) == cfg.epochs
    np.testing.assert_array_equal(prng.key_data(after.key), data(key))


def test_train_state_key_carries_across_from_jax():
    """A JAX ``TrainState.key`` (a typed key's words) set into the port's
    train state draws what it draws there."""
    jk = jax.random.fold_in(jax.random.key(12), 3)
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 4,
                     packed_obs=True)
    state, net, cfg, tx = ppo.ppo_init(venv, 0, config=ppo.PPOConfig(rollout_steps=2),
                                       hidden=32, net_kwargs=dict(encoder='mlp'))
    state = state.replace(key=prng.as_key(data(jk), 'cpu'))
    after, _, _, _ = ppo.make_train_step(venv, net, cfg, tx).rollout_phase(state)
    np.testing.assert_array_equal(
        prng.key_data(after.key), data(jax.random.split(jax.random.split(jk)[0])[0]))


@pytest.mark.parametrize('draw', [
    lambda k, **kw: prng.split(k, (6, 2), **kw),
    lambda k, **kw: prng.bits(k, (6, 5), **kw),
    lambda k, **kw: prng.uniform(k, (6, 2), -2.0, 3.0, **kw),
    lambda k, **kw: prng.gumbel(k, (6, 4, 7), **kw),
    lambda k, **kw: prng.randint(k, (6, 4), 0, 7, **kw),
    lambda k, **kw: prng.randint(k, (), 0, 4096, **kw),
    lambda k, **kw: prng.randint(k, (6, 2), 0, [3, 5], **kw)],
    ids=['split', 'bits', 'uniform', 'gumbel', 'randint', 'randint-scalar', 'randint-bounds'])
@pytest.mark.parametrize('rows', [None, (2, 5)])
def test_split_first_is_the_split_then_the_draw(draw, rows):
    """``k', out = draw(k, ..., split_first=True)`` is ``k', sub =
    split(k)`` then ``draw(sub, ...)``, for one key and a batch of keys,
    with a process's rows (every mode: PAIR, BITS, UNIFORM, GUMBEL,
    RANDINT)."""
    for keys in (prng.key(3), prng.split(prng.key(4), (2, 3))):
        if rows is not None and draw(keys).dim() == keys.dim() - 1:
            continue  # a 0-d draw has no rows
        kw = {} if rows is None else dict(rows=rows)
        carried, out = draw(keys, split_first=True, **kw)
        pair = prng.split(keys)
        assert torch.equal(carried, pair[..., 0, :])
        assert torch.equal(out, draw(pair[..., 1, :], **kw))


def test_learner_split_first_draws_are_the_jax_learners_keys():
    """The fused draws' carried keys are JAX's: a rollout's ``key, k_act =
    split(key)`` chain and a permutation round's ``split``."""
    key = jax.random.key(21)
    tk = prng.as_key(data(key), 'cpu')
    for _ in range(3):
        key, k_act = jax.random.split(key)
        tk, noise = prng.gumbel(tk, (3, 4), split_first=True)
        np.testing.assert_array_equal(prng.key_data(tk), data(key))
        assert_gumbel_close(noise.numpy(), jax.random.gumbel(k_act, (3, 4)))


# ----------------------------------------------- the kernels' code on the host

SHIM = r'''
#include "prng_core.cuh"

// R1 over an emulated grid of ``threads`` threads, each walking its
// elements as the kernel's grid-stride loop does; keys_out null or (k, 2).
extern "C" void mgt_draw_host(const int64_t* keys, long long k, long long count,
                              long long offset, int mode, const int64_t* spans, int span_len,
                              int minval, float fmin, float fmax, void* out, int64_t* keys_out,
                              long long threads) {
  const mgt_prng::DrawArgs a = {keys, keys_out, k, count, (uint64_t)offset, mode, spans,
                                span_len, minval, fmin, fmax, out};
  for (long long t = 0; t < threads; ++t) mgt_prng::draw_strided(a, t, threads);
}

template <int N>
void step_draws_host(const int64_t* rng, long long e, int n, int mode, int32_t* order,
                     int64_t* out) {
  for (long long i = 0; i < e; ++i) {
    uint32_t r[2], g[2] = {0, 0}, f[2] = {0, 0};
    mgt_prng::step_draws_env<N>((uint32_t)rng[2 * i], (uint32_t)rng[2 * i + 1], n, mode,
                                order + i * n, r, g, f);
    const uint32_t v[6] = {r[0], r[1], g[0], g[1], f[0], f[1]};
    for (int j = 0; j < 6; ++j) out[6 * i + j] = v[j];
  }
}

// R2's per-env body as the launcher picks it (the unrolled instance for
// teams of up to kMaxUnrolledAgents), or the generic body where asked.
extern "C" void mgt_step_draws_host(const int64_t* rng, long long e, int n, int mode,
                                    int32_t* order, int64_t* out, int generic) {
  static_assert(mgt_prng::kMaxUnrolledAgents == 8, "an instance below for each team size");
  switch (generic || n > mgt_prng::kMaxUnrolledAgents ? 0 : n) {
    case 1: step_draws_host<1>(rng, e, n, mode, order, out); break;
    case 2: step_draws_host<2>(rng, e, n, mode, order, out); break;
    case 3: step_draws_host<3>(rng, e, n, mode, order, out); break;
    case 4: step_draws_host<4>(rng, e, n, mode, order, out); break;
    case 5: step_draws_host<5>(rng, e, n, mode, order, out); break;
    case 6: step_draws_host<6>(rng, e, n, mode, order, out); break;
    case 7: step_draws_host<7>(rng, e, n, mode, order, out); break;
    case 8: step_draws_host<8>(rng, e, n, mode, order, out); break;
    default: step_draws_host<0>(rng, e, n, mode, order, out);
  }
}
'''


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    assert gxx, 'the logic test builds csrc/prng_core.cuh with g++'
    tmp = tmp_path_factory.mktemp('prng_core')
    (tmp / 'shim.cpp').write_text(SHIM)
    so = tmp / 'libprng_core.so'
    built = subprocess.run([gxx, '-std=c++17', '-O2', '-ffp-contract=off', '-shared', '-fPIC',
                            '-I', str(CSRC_DIR), '-o', str(so), str(tmp / 'shim.cpp')],
                           capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    out = ctypes.CDLL(str(so))
    out.mgt_draw_host.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                                  + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong])
    out.mgt_draw_host.restype = None
    out.mgt_step_draws_host.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int]
    out.mgt_step_draws_host.restype = None
    return out


MODES = [prng.PAIR, prng.BITS, prng.UNIFORM, prng.GUMBEL, prng.RANDINT]
SPANS = torch.tensor([7, 4, 1000, 0, 2**31 + 1], dtype=torch.int64)
DRAW_KW = dict(spans=SPANS, minval=-3, fmin=-1.5, fmax=2.0)


def host_draw(lib, keys, count, offset, mode, threads, split_first=False):
    """R1's per-element code through the g++ build, on an emulated grid of
    ``threads`` threads: the draw, or ``(k', draw)`` with ``split_first``."""
    k = keys.shape[0]
    out = torch.empty(prng.draw_plain(keys[:1], count, offset, mode, **DRAW_KW).shape[1:],
                      dtype=prng.draw_plain(keys[:1], 1, 0, mode, **DRAW_KW).dtype)
    out = out.new_empty((k,) + tuple(out.shape))
    carried = torch.full((k, 2), -1, dtype=torch.int64) if split_first else None
    lib.mgt_draw_host(keys.data_ptr(), k, count, offset, mode, SPANS.data_ptr(), 5, -3, -1.5,
                      2.0, out.data_ptr(), None if carried is None else carried.data_ptr(),
                      threads)
    return out if carried is None else (carried, out)


def assert_draws_equal(mode, got, want):
    if mode == prng.GUMBEL:
        assert_gumbel_close(got.numpy(), want.numpy())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('k,count,offset', [(1, 4099, 0), (37, 5, 1000), (3, 2, 2**32 + 5)])
def test_kernel_draws_are_the_plain_draws(lib, mode, k, count, offset):
    """R1's per-element code: every mode at a range of flat indices,
    offsets past 2**32 included, one element a thread."""
    keys = prng.split(prng.key(k + count), k)
    plain = prng.draw_plain(keys, count, offset, mode, **DRAW_KW)
    assert_draws_equal(mode, host_draw(lib, keys, count, offset, mode, k * count), plain)


# Keys, count and offset of a split-first draw: one key (the path's key
# chain) and 37, offsets past 2**32, rows 5..8 of a (10, 4) draw (a
# process's rows: offset 20, count 12), a count of 0 (the split alone).
SPLIT_CASES = [(1, 16384, 0), (37, 5, 1000), (1, 7, 2**32 + 5), (37, 3, 2**33 - 1),
               (37, 12, 20), (5, 0, 0)]


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('k,count,offset', SPLIT_CASES)
def test_kernel_split_draws_are_the_plain_split_draws(lib, mode, k, count, offset):
    """R1's split prologue: ``k'`` and the draw from ``sub`` of ``k', sub =
    split(k)`` in one walk, equal to ``draw_plain``'s split then draw, on
    grids of one element a thread, one thread and 7 threads (a thread
    crossing keys)."""
    keys = prng.split(prng.key(k + count + 1), k)
    want_k, want = prng.draw_plain(keys, count, offset, mode, split_first=True, **DRAW_KW)
    pair = prng.draw_plain(keys, 2, 0, prng.PAIR)
    assert torch.equal(want_k, pair[:, 0])
    assert_draws_equal(mode, want, prng.draw_plain(pair[:, 1], count, offset, mode, **DRAW_KW))
    for threads in (max(1, k * count), 1, 7):
        got_k, got = host_draw(lib, keys, count, offset, mode, threads, split_first=True)
        assert torch.equal(got_k, want_k)
        assert_draws_equal(mode, got, want)


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('e,n', [(4096, 4), (4096, 2), (257, 1), (2048, 64), (513, 3), (513, 8),
                                 (1024, 16)])
def test_kernel_step_draws_are_the_plain_step_draws(lib, mode, e, n):
    """R2's per-env code as the launcher picks it (teams of up to 8 unrolled,
    16 and 64 the generic body): the order, the carried key and the fresh
    episode's keys."""
    assert_step_draws(lib, e, n, mode, generic=False)


def assert_step_draws(lib, e, n, mode, generic, seed=None):
    rng = prng.split(prng.key(e + n if seed is None else seed), e)
    order, new, gen, fresh = prng.step_draws_plain(rng, n, mode)
    got = torch.full((e, n), -1, dtype=torch.int32)
    keys = torch.zeros((e, 6), dtype=torch.int64)
    lib.mgt_step_draws_host(rng.data_ptr(), e, n, mode, got.data_ptr(), keys.data_ptr(),
                            int(generic))
    assert torch.equal(got, order)
    assert torch.equal(keys[:, :2], new)
    if gen is not None:
        assert torch.equal(keys[:, 2:4], gen)
    if fresh is not None:
        assert torch.equal(keys[:, 4:], fresh)
    return rng


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('n', [1, 2, 3, 4, 8])
def test_kernel_step_draws_generic_body_is_the_unrolled_one(lib, mode, n):
    """The generic body (R2 past 8 agents) on the unrolled bodies' team
    sizes: both the plain version's."""
    assert_step_draws(lib, 512, n, mode, generic=True)


def ties(rng, n):
    """Whether each env's agents' order uniforms tie."""
    u = prng.uniform(prng.split(rng)[:, 0], (n,))
    return torch.tensor([len(torch.unique(row)) < n for row in u])


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
def test_kernel_step_draws_rank_ties_by_index(lib, mode):
    """The generic body at 64 agents in 8192 envs, where float32 uniforms
    tie in a few envs: the order there is the plain version's (a stable
    argsort)."""
    rng = assert_step_draws(lib, 8192, 64, mode, generic=False, seed=77)
    assert ties(rng, 64).any(), 'no ties drawn'


#: Keys whose n agents' order uniforms tie (found by a search over random
#: keys: one in ~2**23 / (n (n - 1) / 2)).
TIED_KEYS = {2: [(1702916, 2418982956), (3394354283, 1835291945)],
             3: [(2533725248, 686978845), (4284064930, 775414574)],
             4: [(3786593334, 3303290612), (1104135269, 598074742)],
             8: [(515005830, 3466818898), (951060277, 723438083)]}


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('n', sorted(TIED_KEYS))
def test_kernel_step_draws_unrolled_rank_ties_by_index(lib, mode, n):
    """The unrolled bodies on keys whose agents tie, beside untied ones:
    the order is the plain version's stable argsort."""
    rng = torch.cat([torch.tensor(TIED_KEYS[n], dtype=torch.int64),
                     prng.split(prng.key(n), 6)])
    assert ties(rng, n).tolist() == [True, True] + [False] * 6
    order, new, gen, fresh = prng.step_draws_plain(rng, n, mode)
    got = torch.full((8, n), -1, dtype=torch.int32)
    keys = torch.zeros((8, 6), dtype=torch.int64)
    lib.mgt_step_draws_host(rng.data_ptr(), 8, n, mode, got.data_ptr(), keys.data_ptr(), 0)
    assert torch.equal(got, order)
    assert torch.equal(keys[:, :2], new)
