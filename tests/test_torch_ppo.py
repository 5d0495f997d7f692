"""The port's shared-policy PPO ≡ the JAX package's, phase by phase.

The phases are compared through the JAX train step's own handles
(``compute_gae``, ``sgd_step``), called without jit on the same params,
``Rollout`` and optimizer state (no JAX train step is compiled). The
learner is compared on both of its paths: the fused PPO-loss kernel's
(JAX in Pallas interpret mode, float32; the port's plain version, float32)
and autograd of the loss (both bf16 nets). The optimizer is held against
optax, the packed observations and the minibatch shuffle against the JAX
package's, and the rollout and the CLI are run on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.learn import ppo as jax_ppo
from multigrid_tpu.learn.nets import ActorCritic as JaxActorCritic
from multigrid_tpu.ops.step import sample_order as jax_sample_order
from multigrid_tpu.parallel import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch import train as train_cli
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import ActorCritic, params_from_flax
from multigrid_tpu_torch.ops import fused_linear, fused_ppo
from multigrid_tpu_torch.parallel import VectorEnv

torch.set_num_threads(1)

ENV_ID = 'MultiGrid-Empty-5x5-v0'
T, E, N, H = 2, 64, 2, 32   # B = 256: the JAX kernel's gate holds
CONFIG = dict(rollout_steps=T, gamma=0.97, gae_lambda=0.9)


@pytest.fixture(scope='module')
def setup():
    """JAX and port learners over the same env and flax weights, and a
    random trajectory as numpy."""
    jnet = JaxActorCritic(encoder='mlp', packed_obs=True, hidden=H)
    params = jax.device_get(jnet.init(jax.random.key(0), jnp.zeros(49, jnp.int32),
                                      jnp.zeros((), jnp.int32)))
    rng = np.random.default_rng(0)
    cells = (rng.integers(0, 11, (T, E, N, 49)) << 8) \
        | (rng.integers(0, 6, (T, E, N, 49)) << 4) | rng.integers(0, 4, (T, E, N, 49))
    traj = dict(
        image=cells.astype(np.int32),
        direction=rng.integers(0, 4, (T, E, N)).astype(np.int32),
        action=rng.integers(0, 7, (T, E, N)).astype(np.int32),
        log_prob=(np.log(1 / 7) + 0.3 * rng.normal(size=(T, E, N))).astype(np.float32),
        value=rng.normal(size=(T, E, N)).astype(np.float32),
        reward=np.where(rng.random((T, E, N)) < 0.2, rng.random((T, E, N)), 0
                        ).astype(np.float32),
        done=rng.random((T, E, N)) < 0.3)
    last_value = rng.normal(size=(E, N)).astype(np.float32)
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), E, packed_obs=True)
    return jnet, params, traj, last_value, venv


def _jax_step(jnet, config, fused):
    jvenv = JaxVectorEnv(jax_make(ENV_ID, agents=N), E, packed_obs=True)
    tx = optax.chain(optax.clip_by_global_norm(config.max_grad_norm),
                     optax.adam(config.lr))
    jax_ppo.FUSED_INTERPRET = fused
    try:
        return jax_ppo.make_train_step(jvenv, jnet, config, tx), tx
    finally:
        jax_ppo.FUSED_INTERPRET = False


def _port_step(venv, supports=fused_ppo.supports, monkeypatch=None):
    net = ActorCritic(49, hidden=H, packed_obs=True)
    config = ppo.PPOConfig(**CONFIG)
    if monkeypatch is not None:
        monkeypatch.setattr(fused_ppo, 'supports', supports)
    return ppo.make_train_step(venv, net, config,
                               ppo.Optimizer(config.lr, config.max_grad_norm))


def _rollouts(traj):
    jt = jax_ppo.Rollout(**{k: jnp.asarray(v) for k, v in traj.items()})
    pt = ppo.Rollout(**{k: torch.as_tensor(v) for k, v in traj.items()})
    return jt, pt


def test_compute_gae_matches_jax(setup):
    jnet, _, traj, last_value, venv = setup
    jstep, _ = _jax_step(jnet, jax_ppo.PPOConfig(**CONFIG), fused=False)
    jt, pt = _rollouts(traj)
    want_adv, want_tg = jstep.compute_gae(jt, jnp.asarray(last_value))
    adv, tg = _port_step(venv).compute_gae(pt, torch.as_tensor(last_value))
    # float32 either way; XLA may fuse a multiply-add where PyTorch rounds twice.
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(want_tg), rtol=1e-6, atol=1e-6)


def _compare_sgd_step(setup, fused, monkeypatch, grad_tol, metric_tol):
    jnet, params, traj, last_value, venv = setup
    config = jax_ppo.PPOConfig(**CONFIG)
    jstep, tx = _jax_step(jnet, config, fused)
    jt, pt = _rollouts(traj)
    adv, tg = jstep.compute_gae(jt, jnp.asarray(last_value))
    jax_ppo.FUSED_INTERPRET = fused
    try:
        jparams, jopt, jmetrics = jstep.sgd_step(
            jax.tree.map(jnp.asarray, params), tx.init(params), jt, adv, tg)
    finally:
        jax_ppo.FUSED_INTERPRET = False
    step = _port_step(venv, fused_ppo.supports if fused else (lambda *a: False),
                      monkeypatch)
    p0 = params_from_flax(params)
    launches = fused_linear.launches, fused_linear.grad_launches, fused_ppo.launches
    new, opt, metrics = step.sgd_step(p0, step.tx.init(p0), pt,
                                      torch.tensor(np.asarray(adv)),
                                      torch.tensor(np.asarray(tg)))
    assert launches == (fused_linear.launches, fused_linear.grad_launches,
                        fused_ppo.launches)  # the CPU takes the plain versions
    for k in ('loss', 'pg_loss', 'vf_loss', 'entropy'):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=metric_tol, atol=1e-6, err_msg=k)
    # Adam's first moment after one step is 0.1 x the clipped gradient.
    want_mu = params_from_flax(jax.device_get(jopt[1][0].mu))
    for k in want_mu:
        err = float((opt.mu[k] - want_mu[k]).abs().max())
        assert err <= grad_tol * float(want_mu[k].abs().max()) + 1e-9, (k, err)
    # The step itself is ±lr·(~1) per element; an element whose gradient
    # is a near-cancelling sum may step the other way.
    want_p = params_from_flax(jax.device_get(jparams))
    for k in want_p:
        diff = (new[k] - want_p[k]).abs()
        assert float(diff.max()) <= 2 * config.lr + 1e-6, k
        assert float((diff > 1e-5).float().mean()) < 0.02, k


def test_sgd_step_on_the_loss_kernel_path_matches_jax(setup, monkeypatch):
    """JAX's Pallas kernel in interpret mode against the port's plain
    version, both float32: grads to 5e-4 relative (test_fused_ppo.py:86-97)."""
    _compare_sgd_step(setup, True, monkeypatch, grad_tol=5e-4, metric_tol=2e-5)


def test_sgd_step_on_the_autograd_path_matches_jax(setup, monkeypatch):
    """The kernel's gate off: autograd through the bf16 nets on both sides.
    bf16 activations round at other points, so grads agree to 5e-2 of each
    leaf's largest (bench.py:85-90) and metrics to 1e-2."""
    _compare_sgd_step(setup, False, monkeypatch, grad_tol=5e-2, metric_tol=1e-2)


def test_optimizer_matches_optax():
    """clip_by_global_norm then adam, at steps 1-3, clipping at steps 1
    and 3 and not at step 2."""
    rng = np.random.default_rng(1)
    params = {'a': rng.normal(size=(5, 3)).astype(np.float32),
              'b': rng.normal(size=(3,)).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    ours = ppo.Optimizer(3e-4, 0.5)
    jstate = tx.init(params)
    state = ours.init({k: torch.as_tensor(v) for k, v in params.items()})
    for scale in (1.0, 0.01, 3.0):
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        want, jstate = tx.update(grads, jstate, params)
        got, state = ours.update({k: torch.as_tensor(v) for k, v in grads.items()}, state)
        # The moments agree exactly. The bias correction 1 - b2**t cancels
        # digits: one float32 ulp of b2**t (a power taken another way) is
        # 2e-5 of it at t = 3.
        for k in params:
            np.testing.assert_array_equal(state.mu[k].numpy(), np.asarray(jstate[1][0].mu[k]))
            np.testing.assert_array_equal(state.nu[k].numpy(), np.asarray(jstate[1][0].nu[k]))
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=5e-5, atol=1e-12)
    assert state.count == int(jstate[1][0].count) == 3


def test_minibatches_match_jax_shuffle():
    """T-permutation, env-axis roll, contiguous env blocks (ppo.py:671-698)."""
    rng = np.random.default_rng(2)
    t, e, m = 4, 12, 3
    x = rng.normal(size=(t, e, N)).astype(np.float32)
    perm, off = rng.permutation(t), 5
    want = jnp.swapaxes(jnp.roll(jnp.take(jnp.asarray(x), jnp.asarray(perm), axis=0),
                                 off, axis=1).reshape(t, m, e // m, N), 0, 1)
    traj = ppo.Rollout(*([torch.as_tensor(x)] * 7))
    got = list(ppo.minibatches((traj, torch.as_tensor(x), torch.as_tensor(x)), m,
                               torch.as_tensor(perm), off))
    assert len(got) == m
    for i, (tr, adv, tg) in enumerate(got):
        np.testing.assert_array_equal(tr.image.numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(adv.numpy(), np.asarray(want[i]))


def test_gumbel_max_is_jax_categorical():
    """Given JAX's own noise, the port's sampler picks JAX's actions."""
    key = jax.random.key(3)
    logits = np.random.default_rng(3).normal(size=(200, 7)).astype(np.float32)
    want = jax.random.categorical(key, jnp.asarray(logits))
    noise = np.asarray(jax.random.gumbel(key, logits.shape))
    got = ppo.sample_actions(torch.as_tensor(logits), torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = ppo.gumbel_noise((4096,), torch.Generator().manual_seed(0), 'cpu')
    assert abs(float(g.mean()) - 0.5772) < 0.05  # Euler-Mascheroni


def test_packed_vector_env_matches_jax():
    """Packed observations, reset and steps, bit-equal to the JAX package's
    ``VectorEnv(packed_obs=True)`` under the same actions and orders."""
    kw = dict(agents=N, see_through_walls=True)
    jvenv = JaxVectorEnv(jax_make(ENV_ID, **kw), 8, packed_obs=True)
    venv = VectorEnv(make(ENV_ID, device='cpu', **kw), 8, packed_obs=True)
    jobs, jstate = jvenv.reset(jax.random.key(0))
    obs, state = venv.reset(seed=0)
    assert obs['image'].shape == (8, N, 49)
    np.testing.assert_array_equal(obs['image'].numpy(), np.asarray(jobs['image']))
    draw_order = jax.vmap(lambda s: jax_sample_order(jax.random.split(s.rng)[0], N))
    rng = np.random.default_rng(4)
    for t in range(3):
        actions = rng.integers(0, 7, (8, N)).astype(np.int32)
        order = np.asarray(draw_order(jstate))
        jobs, jstate, *_ = jvenv.step(jstate, jnp.asarray(actions))
        obs, state, *_ = venv.step(state, torch.as_tensor(actions),
                                   order=torch.as_tensor(order.copy()))
        np.testing.assert_array_equal(obs['image'].numpy(), np.asarray(jobs['image']),
                                      err_msg=str(t))
    np.testing.assert_array_equal(venv.observe(state)['image'].numpy(),
                                  np.asarray(jvenv.observe(jstate)['image']))


def test_packed_obs_needs_an_unwrapped_env():
    env = make(ENV_ID, device='cpu')

    class Wrapped(type(env)):
        def transform_obs(self, obs, state):
            return obs

    env.__class__ = Wrapped
    with pytest.raises(ValueError, match='unwrapped'):
        VectorEnv(env, 2, packed_obs=True)


def _params_moved(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def test_train_step_runs_on_the_cpu():
    """Three updates on Empty-5x5 (E 8, N 2, T 4, hidden 32), then one with
    2 epochs of 4 minibatches: finite metrics, every parameter moves."""
    venv = VectorEnv(make(ENV_ID, agents=2, device='cpu'), 8, packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 0, config=ppo.PPOConfig(rollout_steps=4),
                                          hidden=32)
    step = ppo.make_train_step(venv, net, config, tx)
    p0 = state.params
    for _ in range(3):
        state, metrics = step(state)
        for k in ('loss', 'pg_loss', 'vf_loss', 'entropy', 'reward_per_step'):
            assert np.isfinite(float(metrics[k])), k
    assert state.update_count == 3 and state.opt_state.count == 3
    assert sorted(_params_moved(p0, state.params)) == sorted(p0)
    step2 = ppo.make_train_step(venv, net, config.replace(epochs=2, minibatches=4), tx)
    state, metrics = step2(state)
    assert state.opt_state.count == 3 + 2 * 4
    assert np.isfinite(float(metrics['loss']))


def test_train_loop_means_its_updates():
    """``make_train_loop`` runs its updates in turn; its metrics are their
    NaN-skipping means (``episode_reward`` is NaN where none ended)."""
    venv = VectorEnv(make(ENV_ID, agents=2, device='cpu'), 8, packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 2, config=ppo.PPOConfig(rollout_steps=4),
                                          hidden=32)
    gen = state.generator.get_state(), venv.generator.get_state()
    loop = ppo.make_train_loop(venv, net, config, tx, 3)
    after, metrics = loop(state)
    assert after.update_count == 3
    state.generator.set_state(gen[0])
    venv.generator.set_state(gen[1])
    step, rows = ppo.make_train_step(venv, net, config, tx), []
    for _ in range(3):
        state, m = step(state)
        rows.append(m)
    for k in metrics:
        want = torch.nanmean(torch.stack([r[k].float() for r in rows]))
        torch.testing.assert_close(metrics[k], want, equal_nan=True)
    for k in after.params:
        assert torch.equal(after.params[k], state.params[k]), k


def test_rollout_pairs_each_obs_with_its_action():
    """The stored log-prob and value are the policy's on the stored obs;
    ``done`` is the env's done or the agent's termination; a finished
    episode's return is banked once."""
    venv = VectorEnv(make(ENV_ID, agents=2, max_steps=3, device='cpu'), 8, packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 1, config=ppo.PPOConfig(rollout_steps=5),
                                          hidden=32)
    step = ppo.make_train_step(venv, net, config, tx)
    state, traj, last_value, (ep_sum, ep_cnt, _) = step.rollout_phase(state)
    with torch.no_grad():
        logits, value = step.policy(state.params, {'image': traj.image,
                                                   'direction': traj.direction})
    torch.testing.assert_close(traj.value, value)
    torch.testing.assert_close(traj.log_prob, ppo._select_log_prob(logits, traj.action))
    assert traj.image.shape == (5, 8, 2, 49) and last_value.shape == (8, 2)
    assert int(ep_cnt) == 8  # max_steps 3: every env ends once in 5 steps
    assert traj.done[2].all()
    assert float(ep_sum) == pytest.approx(float(traj.reward[:3].sum()), abs=1e-6)


def test_cli_trains_at_a_tiny_size(tmp_path, capsys):
    log = tmp_path / 'log.jsonl'
    train_cli.main(['--device', 'cpu', '--env', ENV_ID, '--num-agents', '2',
                    '--num-envs', '8', '--rollout-steps', '4', '--num-timesteps', '192',
                    '--hidden', '32', '--log-interval', '2', '--log-jsonl', str(log)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith('training MultiGrid-Empty-5x5-v0: 2 agents x 8 envs, 3 updates')
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r['update'] for r in rows] == [2, 3]
    assert [json.loads(line) for line in out[1:]] == rows
    assert set(rows[0]) == {'update', 'agent_steps', 'agent_steps_per_sec',
                            'steps_per_sec_window', 'reward_per_step', 'loss', 'entropy',
                            'episode_reward', 'episodes_in_batch', 'success_rate'}
    assert rows[-1]['agent_steps'] == 192 and np.isfinite(rows[-1]['loss'])
    with pytest.raises(SystemExit):
        train_cli.parse_args(['--encoder', 'cnn'])  # no flag it would ignore
