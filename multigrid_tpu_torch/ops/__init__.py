"""Environment functions on batched tensors: transition and observation
(each a plain version and a CUDA kernel wrapper), placement."""

from .obs import (
    gen_obs,
    gen_obs_batched_plain,
    gen_obs_grid,
    gen_obs_grid_encoding,
    get_vis_mask,
)
from .obs_cuda import gen_obs_batched
from .step import handle_actions, handle_actions_plain, sample_order, step_with_order


_owners: list = []


def launch_owners() -> list[tuple[str, object, str]]:
    """``(name, module, attribute)`` of each kernel wrapper's launch count,
    in :func:`launch_counts`' order (resolved at the first call)."""
    if not _owners:
        from . import (fused_linear, fused_policy, fused_ppo, merge_cuda, obs_cuda, prng_cuda,
                       step_cuda)
        _owners.extend([
            ('obs', obs_cuda, 'launches'), ('obs_general', obs_cuda, 'general_launches'),
            ('onehot_linear', fused_linear, 'launches'),
            ('onehot_linear_grad', fused_linear, 'grad_launches'),
            ('ppo_loss', fused_ppo, 'launches'), ('policy_sample', fused_policy, 'launches'),
            ('step', step_cuda, 'launches'), ('threefry', prng_cuda, 'launches'),
            ('step_draws', prng_cuda, 'step_launches'),
            ('reset_merge', merge_cuda, 'launches')])
    return _owners


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process (each wrapper adds
    one where it launches its kernel on the card)."""
    return {name: getattr(owner, attr) for name, owner, attr in launch_owners()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' launch counts named in ``counts`` (keys as
    :func:`launch_counts` gives them)."""
    owners = {name: (owner, attr) for name, owner, attr in launch_owners()}
    for name, n in counts.items():
        setattr(*owners[name], n)


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    set_launch_counts(dict.fromkeys(launch_counts(), 0))


__all__ = [
    'gen_obs', 'gen_obs_batched', 'gen_obs_batched_plain', 'gen_obs_grid',
    'gen_obs_grid_encoding', 'get_vis_mask', 'handle_actions', 'handle_actions_plain',
    'launch_counts', 'launch_owners', 'sample_order', 'set_launch_counts', 'step_with_order',
    'zero_launch_counts',
]
