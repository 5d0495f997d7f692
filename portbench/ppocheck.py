"""The comparison that decides ``correct`` in the PPO cells.

Set-up drives the program's training step from the seed through its first
``check_updates`` updates, through the window's own call, and keeps the
train state before and after each. Once the window has closed the plain
reference (:mod:`portbench.reference.learner`) checks the start, then
follows the program update by update from the program's own state before
each (its parameters, Adam's moments and count, the envs, the last
observations and the key): the reference's rollout samples from bf16
logits as the program's does, so from anything but the same parameters a
near tie would go the other way now and then and an env play on
differently. The numbers compared:

- ``start_differs``: envs whose reset state or first observation is not
  the reference's reset from the same key, and parameters that are not
  the weights the benchmark made (exact);
- ``loss_gap``: the largest gap of an update's loss (its last
  minibatch's) to the reference's, over the reference's sum of the
  magnitudes of its terms (the policy term, which crosses 0, and the value
  and entropy terms);
- ``moment_gap``: after the first update, the worst leaf's gap between the
  norms of Adam's first moment (the gradients as the optimizer got them;
  with one minibatch an update, the first gradient times 0.1), over the
  larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of each leaf's change over the updates (the
  reference's the sum of its updates' changes);
- ``envs_differ``: the largest share, over the updates, of envs whose
  state after the update is not the reference's.

Leaves whose first gradient in the reference is under a thousandth of
the median leaf's move by round-off alone and would be left out of the
change; these nets have none.
"""

from __future__ import annotations

import torch

from .envcheck import as_reference, envs_differ
from .harness import Check
from .reference.envs import make
from .reference.learner import Learner, Net, PPOConfig, TrainState
from .reference.vector import PlainVectorEnv

#: The limits proposed from ``bup-ppo``'s readings on the card (PERF.md):
#: no cell of ``BENCHMARK.json`` runs this comparison yet.
LIMITS = {'loss_gap': 0.008, 'moment_gap': 0.25, 'change_gap': 0.03, 'envs_differ': 0.01}


def reference_learner(config: dict, traffic: dict, device, lowp: bool = False) -> Learner:
    env = make(config['env_id'], agents=config['agents'],
               agent_view_size=config['agent_view_size'], max_steps=config['max_steps'],
               device=device)
    venv = PlainVectorEnv(env, config['num_envs'], packed_obs=True,
                          reset_pool=config['reset_pool'])
    missions = config['net'].get('missions', 0)
    cfg = PPOConfig(traffic['rollout_steps'], traffic['epochs'], traffic['minibatches'])
    return Learner(venv, Net(missions, lowp=lowp), cfg)


def as_reference_train(s, device) -> TrainState:
    """A program's train state read by its fields' names, as the
    reference's."""
    def copy(tree):
        return {k: None if v is None else v.to(device).clone() for k, v in tree.items()}
    return TrainState(copy(s.params), copy(s.opt_state.mu), copy(s.opt_state.nu),
                      int(s.opt_state.count), as_reference(s.env_state), copy(s.last_obs),
                      s.key.to(device).clone())


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's."""
    p, r = _norms(program), _norms(reference)
    names = [k for k in r if keep is None or k in keep]
    median = float(torch.tensor([r[k] for k in names]).median())
    return max(abs(p[k] - r[k]) / max(r[k], median) for k in names)


def compare(learner: Learner, params: dict, key, states: list, losses: list) -> list[Check]:
    """``states``: the program's train state before the first update and
    after each; ``losses``: each update's loss."""
    dev = learner.venv.device
    start = learner.init(params, key)
    first = as_reference_train(states[0], dev)
    start_differs = (envs_differ(first.env_state, start.env_state)
                     + int((first.last_obs['image'] != start.last_obs['image']).reshape(
                         start.env_state.grid.shape[0], -1).any(-1).sum())
                     + sum(not torch.equal(first.params[k], params[k]) for k in params))
    loss_gap, differ, change_r, mu1, grads1 = 0.0, 0.0, None, None, None
    for before, after, loss_p in zip(states, states[1:], losses):
        s = as_reference_train(before, dev)
        r, (loss_r, scale), grads = learner.update(s)
        loss_gap = max(loss_gap, abs(loss_p - float(loss_r)) / float(scale))
        differ = max(differ, envs_differ(as_reference(after.env_state), r.env_state)
                     / learner.venv.num_envs)
        step = {k: r.params[k] - s.params[k] for k in params}
        change_r = step if change_r is None else {k: change_r[k] + step[k] for k in params}
        if mu1 is None:
            mu1, grads1 = r.mu, grads
    g = _norms(grads1)
    median = float(torch.tensor(list(g.values())).median())
    moving = {k for k, v in g.items() if v >= 1e-3 * median}
    last = states[-1].params
    change_p = {k: last[k].to(dev) - first.params[k] for k in params}
    mu_p = {k: v.to(dev) for k, v in states[1].opt_state.mu.items()}
    return [Check('start_differs', start_differs, 0),
            Check('loss_gap', loss_gap, LIMITS['loss_gap']),
            Check('moment_gap', leaf_gap(mu_p, mu1), LIMITS['moment_gap']),
            Check('change_gap', leaf_gap(change_p, change_r, moving), LIMITS['change_gap']),
            Check('envs_differ', differ, LIMITS['envs_differ'])]
