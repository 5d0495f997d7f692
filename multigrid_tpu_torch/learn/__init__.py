"""PPO training: the mlp ``ActorCritic`` and the shared-policy learner."""

from .nets import OBS_CHANNELS, ActorCritic, one_hot_image, params_from_flax, params_to_flax
from .ppo import (
    Optimizer,
    PPOConfig,
    Rollout,
    TrainState,
    make_train_loop,
    make_train_step,
    ppo_init,
)

__all__ = [
    'OBS_CHANNELS', 'ActorCritic', 'Optimizer', 'PPOConfig', 'Rollout',
    'TrainState', 'make_train_loop', 'make_train_step', 'one_hot_image',
    'params_from_flax', 'params_to_flax', 'ppo_init',
]
