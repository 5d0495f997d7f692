"""Environment functions on batched tensors: transition, observation
(plain version and CUDA kernel wrapper), placement."""

from .obs import gen_obs, gen_obs_batched_plain, gen_obs_grid_encoding, get_vis_mask
from .obs_cuda import gen_obs_batched
from .step import handle_actions, sample_order, step_with_order

__all__ = [
    'gen_obs', 'gen_obs_batched', 'gen_obs_batched_plain',
    'gen_obs_grid_encoding', 'get_vis_mask', 'handle_actions', 'sample_order',
    'step_with_order',
]
