"""The rollout's whole policy step, packed cells to (action, log-prob, value),
through a hand-written CUDA kernel.

Counterpart of ``multigrid_tpu.ops.fused_policy``: :func:`policy_sample`
runs the mlp ``ActorCritic`` forward on packed cells, samples each action by
Gumbel-max from noise the caller draws (the first index on ties, as
``jax.random.categorical``), and returns the action's log-prob and the
value, in the kernel ``csrc/fused_policy.cu`` (replacing ``_kernel``) on the
card and in :func:`policy_sample_plain` on the CPU. The logits and the
(B, H) activations never reach device memory.

The arithmetic is the TPU kernel's, not the unfused net's: the trunk's
bias and both heads stay in float32 (the net rounds each ``Dense`` output
to bf16), so in bf16 the two may pick different actions where the top two
perturbed logits nearly tie.

:func:`prepare` makes the kernel's weight operands from flax-named
parameters once; a rollout calls it once and :func:`policy_sample_prepared`
every step.
"""

from __future__ import annotations

import torch

from . import fused_linear
from .fused_linear import NCH, check_cuda

SOURCE = 'fused_policy.cu'

#: Kernel launches through :func:`policy_sample_prepared` since the count
#: was last set to 0.
launches = 0

#: The kernel's range: hidden widths it is built for, actions, and
#: direction (and mission) features.
HIDDEN = (32, 64, 128, 256)
MAX_ACTIONS = 8
MAX_FEATURES = 15

_fns = {}


def supports(batch: int, hidden: int, num_actions: int) -> bool:
    """Whether the kernel takes this batch, hidden width and action count."""
    return batch >= 1 and hidden in HIDDEN and 1 <= num_actions <= MAX_ACTIONS


def _lib_fn():
    if 'launch' not in _fns:
        import ctypes

        from ..utils import build
        fn = build.load(SOURCE).mgt_policy_sample_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns['launch'] = fn
    return _fns['launch']


def prepare(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The kernel's weight operands from flax-named ``ActorCritic`` params:
    ``w_img``, ``wd`` = ``[W0; b0]``, ``w1``, ``wa``, ``wv`` in bf16 on the
    card (the kernel's operand type) and float32 on the CPU (the plain
    version's), ``b1``, ``ba``, ``bv`` float32; all contiguous, and the
    matrices 16-byte aligned (the kernel copies W_img and W1 in 16-byte
    pieces)."""
    mat = torch.bfloat16 if params['img_kernel'].device.type == 'cuda' else torch.float32

    def m(x):
        t = x.detach().to(mat).contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    def v(x):
        return x.detach().float().contiguous()

    return {'w_img': m(params['img_kernel']),
            'wd': m(torch.cat([params['Dense_0.kernel'], params['Dense_0.bias'][None]], 0)),
            'w1': m(params['Dense_1.kernel']), 'b1': v(params['Dense_1.bias']),
            'wa': m(params['Dense_2.kernel']), 'ba': v(params['Dense_2.bias']),
            'wv': m(params['Dense_3.kernel']), 'bv': v(params['Dense_3.bias'])}


def policy_heads_plain(w, packed, dirf, *, compute_dtype=torch.float32):
    """The kernel's forward, step by step, on :func:`prepare`'s operands:
    float32 ``(logits (B, A), value (B,))``, every matrix operand rounded to
    ``compute_dtype``, float32 sums."""
    def q(x):
        return x.to(compute_dtype).float()

    f32 = torch.float32
    b = packed.shape[0]
    dirf1 = q(torch.cat([dirf.to(f32), dirf.new_ones((b, 1), dtype=f32)], 1))
    h = fused_linear.onehot_features(packed) @ q(w['w_img']) + dirf1 @ q(w['wd'])
    x1 = q(torch.relu(h))
    x2 = q(torch.relu(x1 @ q(w['w1']) + w['b1']))
    return x2 @ q(w['wa']) + w['ba'], (x2 @ q(w['wv']) + w['bv'])[:, 0]


def policy_sample_plain(w, packed, dirf, gumbel, *, num_actions: int = 7,
                        compute_dtype=torch.float32):
    """Plain version of the kernel on :func:`prepare`'s operands: the same
    arithmetic step by step (:func:`policy_heads_plain`), in float32 on the
    CPU (as the JAX kernel's interpret mode) and with bfloat16 matrix
    operands to match the kernel on the card."""
    b = packed.shape[0]
    if tuple(gumbel.shape) != (b, num_actions):
        raise ValueError(f'gumbel must be ({b}, {num_actions}), got {tuple(gumbel.shape)}')
    logits, value = policy_heads_plain(w, packed, dirf, compute_dtype=compute_dtype)
    action = (logits + gumbel).argmax(-1)  # the first index of the largest
    zmax = logits.max(-1, keepdim=True).values
    logp = logits - zmax - torch.log(torch.exp(logits - zmax).sum(-1, keepdim=True))
    return action.to(torch.int32), logp.gather(-1, action[:, None])[:, 0], value


def policy_sample_prepared(w, packed, dirf, gumbel, *, num_actions: int = 7):
    """:func:`policy_sample` on operands from :func:`prepare`. CUDA tensors
    launch the kernel; CPU tensors take the plain version in float32."""
    global launches
    if packed.device.type == 'cpu':
        return policy_sample_plain(w, packed, dirf, gumbel, num_actions=num_actions)
    if packed.dim() != 2 or dirf.dim() != 2:
        raise ValueError(f'packed (B, C) and dirf (B, F) expected, got '
                         f'{tuple(packed.shape)} and {tuple(dirf.shape)}')
    b, c = packed.shape
    f = dirf.shape[1]
    h = w['w_img'].shape[-1]
    if not supports(b, h, num_actions) or f > MAX_FEATURES:
        raise ValueError(f'policy_sample kernel does not take batch {b}, hidden {h}, '
                         f'{num_actions} actions, {f} direction features')
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {'w_img': ((c * NCH, h), bf16), 'wd': ((f + 1, h), bf16), 'w1': ((h, h), bf16),
              'b1': ((h,), f32), 'wa': ((h, num_actions), bf16), 'ba': ((num_actions,), f32),
              'wv': ((h, 1), bf16), 'bv': ((1,), f32)}
    ptrs = [check_cuda(packed, 'packed', (b, c), torch.int32),
            check_cuda(dirf, 'dirf', (b, f), f32),
            check_cuda(gumbel, 'gumbel', (b, num_actions), f32)]
    ptrs += [check_cuda(w[k], k, s, dt) for k, (s, dt) in shapes.items()]
    if w['w_img'].data_ptr() % 16 or w['w1'].data_ptr() % 16:
        raise ValueError('policy_sample kernel needs w_img and w1 16-byte aligned '
                         '(prepare() makes them so)')
    dev = packed.device
    action = torch.empty((b,), dtype=torch.int32, device=dev)
    log_prob = torch.empty((b,), dtype=f32, device=dev)
    value = torch.empty((b,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = _lib_fn()(*ptrs, action.data_ptr(), log_prob.data_ptr(), value.data_ptr(),
                        b, c, f, num_actions, h, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'policy_sample kernel launch failed: error {err}')
    launches += 1
    return action, log_prob, value


def policy_sample(params, packed, dirf, gumbel, *, num_actions: int = 7):
    """One rollout policy step of the mlp ``ActorCritic``.

    ``params`` flax-named; ``packed`` (B, C) int32 cells; ``dirf`` (B, F)
    float32 direction (and mission) features; ``gumbel`` (B, A) float32
    noise. Returns ``(action int32 (B,), log_prob f32 (B,), value f32
    (B,))``: the action ``jax.random.categorical`` samples given that noise.
    """
    return policy_sample_prepared(prepare(params), packed, dirf, gumbel,
                                  num_actions=num_actions)
