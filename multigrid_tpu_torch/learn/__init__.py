"""PPO training: the ``ActorCritic`` (mlp or cnn encoder), the centralized
critic, and the learner for shared or per-agent policies."""

from .nets import (
    OBS_CHANNELS,
    ActorCritic,
    CentralizedCritic,
    make_centralized_critic,
    one_hot_image,
    params_from_flax,
    params_to_flax,
)
from .ppo import (
    Optimizer,
    PPOConfig,
    Rollout,
    TrainState,
    linear_schedule,
    make_train_loop,
    make_train_step,
    ppo_init,
)

__all__ = [
    'OBS_CHANNELS', 'ActorCritic', 'CentralizedCritic', 'Optimizer', 'PPOConfig',
    'Rollout', 'TrainState', 'linear_schedule', 'make_centralized_critic',
    'make_train_loop', 'make_train_step', 'one_hot_image', 'params_from_flax',
    'params_to_flax', 'ppo_init',
]
