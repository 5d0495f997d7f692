"""The port's mlp ``ActorCritic`` ≡ the JAX package's flax module.

The same numpy inputs and the same weights (carried across with
``params_from_flax``) go through both; the one-hot features and the
direction features are equal exactly, the logits and values to bf16
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.learn import nets as jax_nets
from multigrid_tpu_torch.learn.nets import (
    OBS_CHANNELS,
    ActorCritic,
    direction_features,
    one_hot_image,
    params_from_flax,
    params_to_flax,
)
from multigrid_tpu_torch.ops.fused_linear import PAD_CELL

torch.set_num_threads(1)


def _triples(rng, shape):
    return np.stack([rng.integers(0, 12, shape), rng.integers(0, 7, shape),
                     rng.integers(0, 5, shape)], -1).astype(np.int32)


def _packed(rng, shape):
    t = _triples(rng, shape)
    cells = (t[..., 0] << 8) | (t[..., 1] << 4) | t[..., 2]
    return np.where(rng.random(shape) < 0.1, PAD_CELL, cells).astype(np.int32)


def test_obs_channels():
    assert OBS_CHANNELS == jax_nets.OBS_CHANNELS


@pytest.mark.parametrize('packed', [False, True])
def test_one_hot_image_equals_jax(packed):
    """Out-of-range fields (type 11, color 6, state 4, the pad cell) included."""
    rng = np.random.default_rng(0)
    image = _packed(rng, (3, 2, 49)) if packed else _triples(rng, (3, 2, 7, 7))
    want = np.asarray(jax_nets.one_hot_image(jnp.asarray(image), jnp.float32,
                                             packed=packed))
    got = one_hot_image(torch.as_tensor(image), torch.float32, packed=packed)
    np.testing.assert_array_equal(got.numpy(), want)


def test_direction_features_equal_jax():
    """cos/sin of the bf16 θ, all four directions, bit for bit."""
    d = np.arange(4, dtype=np.int32)
    theta = jnp.asarray(d).astype(jnp.bfloat16) * (jnp.pi / 2)
    want = np.asarray(jnp.stack([jnp.cos(theta), jnp.sin(theta)], -1).astype(jnp.float32))
    got = direction_features(torch.as_tensor(d)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] != 0  # cos(bf16(π/2))


def _flax_params(packed, hidden, seed):
    net = jax_nets.ActorCritic(encoder='mlp', packed_obs=packed, hidden=hidden)
    image = jnp.zeros((49,) if packed else (7, 7, 3), jnp.int32)
    params = net.init(jax.random.key(seed), image, jnp.zeros((), jnp.int32))
    return net, jax.device_get(params)


def test_params_round_trip():
    _, params = _flax_params(True, 32, 0)
    state = params_from_flax(params)
    net = ActorCritic(49, hidden=32, packed_obs=True, encoder='mlp')
    net.load_state_dict(state)  # the names and shapes are the module's own
    back = params_to_flax(state)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('packed', [True, False])
def test_actor_critic_matches_flax(packed):
    """Logits and values of the same weights on the same observations agree
    to bf16 rounding: both compute the trunk in bf16 from f32 weights, but
    sum the products in other orders, so a bf16 result may differ in its
    last bit (2**-8 relative) and carry that into the next layer."""
    rng = np.random.default_rng(1)
    e, n, hidden = 6, 3, 32
    image = _packed(rng, (e, n, 49)) if packed else _triples(rng, (e, n, 7, 7))
    direction = rng.integers(0, 4, (e, n)).astype(np.int32)
    net_j, params = _flax_params(packed, hidden, 2)
    want_logits, want_value = net_j.apply(params, jnp.asarray(image), jnp.asarray(direction))
    net = ActorCritic(49, hidden=hidden, packed_obs=packed, encoder='mlp')
    net.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        logits, value = net(torch.as_tensor(image), torch.as_tensor(direction))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (e, n, 7) and value.shape == (e, n)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=2e-2, atol=2e-2)


def test_init_is_seeded_and_lecun_scaled():
    a, b = (ActorCritic(49, hidden=64, seed=3, encoder='mlp'),
            ActorCritic(49, hidden=64, seed=3, encoder='mlp'))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    w = a.img_kernel.detach()
    assert abs(float(w.std()) * np.sqrt(49 * 21) - 1) < 0.05
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(49 * 21) + 1e-6
    assert not ActorCritic(49, hidden=64, seed=4, encoder='mlp').img_kernel.detach().equal(w)
