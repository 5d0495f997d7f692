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
noise to the same ulp bound: glibc's ``logf`` is not torch's ``log``); the
CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``prng`` phase).
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


# ----------------------------------------------- the kernels' code on the host

SHIM = r'''
#include "prng_core.cuh"

extern "C" void mgt_draw_host(const int64_t* keys, long long k, long long count,
                              long long offset, int mode, const int64_t* spans, int span_len,
                              int minval, float fmin, float fmax, void* out) {
  for (long long t = 0; t < k * count; ++t)
    mgt_prng::draw_element(keys, t, count, (uint64_t)offset, mode, spans, span_len, minval,
                           fmin, fmax, out);
}

extern "C" void mgt_step_draws_host(const int64_t* rng, long long e, int n, int mode,
                                    int32_t* order, int64_t* out) {
  for (long long i = 0; i < e; ++i) {
    uint32_t r[2], g[2] = {0, 0}, f[2] = {0, 0};
    mgt_prng::step_draws((uint32_t)rng[2 * i], (uint32_t)rng[2 * i + 1], n, mode,
                         order + i * n, r, g, f);
    const uint32_t v[6] = {r[0], r[1], g[0], g[1], f[0], f[1]};
    for (int j = 0; j < 6; ++j) out[6 * i + j] = v[j];
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
                                     ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    out.mgt_draw_host.restype = None
    out.mgt_step_draws_host.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out.mgt_step_draws_host.restype = None
    return out


@pytest.mark.parametrize('mode', [prng.PAIR, prng.BITS, prng.UNIFORM, prng.GUMBEL,
                                  prng.RANDINT])
@pytest.mark.parametrize('k,count,offset', [(1, 4099, 0), (37, 5, 1000), (3, 2, 2**32 + 5)])
def test_kernel_draws_are_the_plain_draws(lib, mode, k, count, offset):
    """R1's per-element code: every mode at a range of flat indices,
    offsets past 2**32 included."""
    keys = prng.split(prng.key(k + count), k)
    spans = torch.tensor([7, 4, 1000, 0, 2**31 + 1], dtype=torch.int64)
    plain = prng.draw_plain(keys, count, offset, mode, spans=spans, minval=-3,
                            fmin=-1.5, fmax=2.0)
    out = torch.empty_like(plain)
    lib.mgt_draw_host(keys.data_ptr(), k, count, offset, mode, spans.data_ptr(), 5, -3,
                      -1.5, 2.0, out.data_ptr())
    if mode == prng.GUMBEL:
        assert_gumbel_close(out.numpy(), plain.numpy())
    else:
        assert torch.equal(out, plain)


@pytest.mark.parametrize('mode', [prng.STEP_ONLY, prng.STEP_EXACT, prng.STEP_POOL])
@pytest.mark.parametrize('e,n', [(4096, 4), (4096, 2), (257, 1), (2048, 64)])
def test_kernel_step_draws_are_the_plain_step_draws(lib, mode, e, n):
    """R2's per-env code: the order (ties at 64 agents included), the
    carried key and the fresh episode's keys."""
    rng = prng.split(prng.key(e + n), e)
    order, new, gen, fresh = prng.step_draws_plain(rng, n, mode)
    got = torch.full((e, n), -1, dtype=torch.int32)
    keys = torch.zeros((e, 6), dtype=torch.int64)
    lib.mgt_step_draws_host(rng.data_ptr(), e, n, mode, got.data_ptr(), keys.data_ptr())
    assert torch.equal(got, order)
    assert torch.equal(keys[:, :2], new)
    if gen is not None:
        assert torch.equal(keys[:, 2:4], gen)
    if fresh is not None:
        assert torch.equal(keys[:, 4:], fresh)
