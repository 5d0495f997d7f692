"""The whole PPO loss, forward and backward, through a hand-written CUDA kernel.

Counterpart of ``multigrid_tpu.ops.fused_ppo``: :func:`ppo_mlp_grads`
computes, for the mlp ``ActorCritic`` on packed cells, every weight and
bias gradient of the clipped-PPO loss and its metrics, in the kernel
``csrc/fused_ppo.cu`` (replacing ``_kernel``) on the card and in
:func:`ppo_mlp_grads_plain` on the CPU. A launch is the loss kernel (the
first layer computed in it, tile by tile), the sum of its per-block
partials, and the gradient kernel of ``csrc/fused_linear.cu`` on the loss
kernel's ``dx1`` for the first layer's weights; it counts once, here.

Per-agent policies take the kernel with an agent axis,
:func:`ppo_mlp_grads_agents`: stacked (N, ...) parameters and (N, B, ...)
samples, one launch for all agents (each agent on its own blocks of the
grid, the gradient kernel's agent axis for their first layers), as the JAX
package ``vmap``s ``ppo_mlp_grads`` over per-agent policies (Pallas's
batching rule adds a leading grid axis). It counts once.

Advantages arrive normalized; parameters and gradients are flax-named
(``img_kernel``, ``Dense_i.kernel``, ``Dense_i.bias``).
"""

from __future__ import annotations

import torch

from . import fused_linear
from .fused_linear import NCH, check_cuda

SOURCE = 'fused_ppo.cu'

#: Kernel launches through :func:`ppo_mlp_grads` and
#: :func:`ppo_mlp_grads_agents` since the count was last set to 0 (a launch
#: over all agents counts once).
launches = 0

#: The kernel's range: hidden widths it is built for, actions, and direction
#: features (with the bias column).
HIDDEN = (32, 64, 128)
MAX_ACTIONS = 8
MAX_FEATURES = 15
#: Samples a block of the loss kernel takes at a time.
TILE = 64

_fns = {}


def supports(batch: int, hidden: int, num_actions: int) -> bool:
    """Whether the kernel takes this batch, hidden width and action count."""
    return batch >= 1 and hidden in HIDDEN and 1 <= num_actions <= MAX_ACTIONS


def _lib_fn(agents: bool = False):
    name = 'mgt_ppo_loss_agents_launch' if agents else 'mgt_ppo_loss_launch'
    if name not in _fns:
        import ctypes

        from ..utils import build
        fn = getattr(build.load(SOURCE), name)
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * (6 + agents)
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _metrics(pg_sum, vf_sum, ent_sum, b, vf_coef, ent_coef):
    pg, vf, ent = pg_sum / b, vf_sum / b, ent_sum / b
    loss = pg + vf_coef * vf - ent_coef * ent
    return {'loss': loss, 'pg_loss': pg, 'vf_loss': vf, 'entropy': ent}


def ppo_mlp_grads_plain(params, packed, dirf, action, old_logp, adv, target, *,
                        clip_eps: float, vf_coef: float, ent_coef: float,
                        num_actions: int = 7, compute_dtype=torch.float32):
    """Plain version of the kernel: the same arithmetic, with every matrix
    operand rounded to ``compute_dtype`` (float32 on the CPU, as the JAX
    kernel's interpret mode; bfloat16 to match the kernel on the card) and
    float32 sums. Returns ``(grads, metrics)``."""
    def q(x):
        return x.to(compute_dtype).float()

    f32 = torch.float32
    b = packed.shape[0]
    f = dirf.shape[1]
    inv_b = 1.0 / b
    w_img = params['img_kernel']
    wd = torch.cat([params['Dense_0.kernel'], params['Dense_0.bias'][None]], 0)
    w1, b1 = params['Dense_1.kernel'], params['Dense_1.bias']
    wa, ba = params['Dense_2.kernel'], params['Dense_2.bias']
    wv, bv = params['Dense_3.kernel'], params['Dense_3.bias']

    m = fused_linear.onehot_features(packed)                   # (B, C·21)
    dirf1 = q(torch.cat([dirf.to(f32), dirf.new_ones((b, 1), dtype=f32)], 1))
    h = m @ q(w_img)
    h = h + dirf1 @ q(wd)
    x1 = q(torch.relu(h))
    x2p = x1 @ q(w1) + b1
    x2 = q(torch.relu(x2p))
    logits = x2 @ q(wa) + ba
    value = (x2 @ q(wv) + bv)[:, 0]

    zmax = logits.max(-1, keepdim=True).values
    ez = torch.exp(logits - zmax)
    sez = ez.sum(-1, keepdim=True)
    logp = logits - zmax - torch.log(sez)
    prob = ez / sez
    onehot = torch.nn.functional.one_hot(action.long(), num_actions).to(f32)
    lp = (logp * onehot).sum(-1)
    ratio = torch.exp(lp - old_logp)
    u1 = ratio * adv
    u2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    verr = value - target
    ent = -(prob * logp).sum(-1)

    coef_pg = torch.where(u1 <= u2, -inv_b * adv * ratio, 0.0)
    dlogits = coef_pg[:, None] * (onehot - prob)
    dlogits = dlogits + (ent_coef * inv_b) * prob * (logp + ent[:, None])
    dv = (vf_coef * inv_b) * verr
    dl16, dv16 = q(dlogits), q(dv)
    dx2 = dl16 @ q(wa).T + dv16[:, None] @ q(wv).T
    dx2p = q(torch.where(x2p > 0, dx2, 0.0))
    dx1 = dx2p @ q(w1).T
    dx1p = q(torch.where(h > 0, dx1, 0.0))

    dwd = dirf1.T @ dx1p
    grads = {
        'img_kernel': m.T @ dx1p,
        'Dense_0.kernel': dwd[:f], 'Dense_0.bias': dwd[f],
        'Dense_1.kernel': x1.T @ dx2p, 'Dense_1.bias': dx2p.sum(0),
        'Dense_2.kernel': x2.T @ dl16, 'Dense_2.bias': dlogits.sum(0),
        'Dense_3.kernel': x2.T @ dv16[:, None], 'Dense_3.bias': dv.sum()[None],
    }
    metrics = _metrics((-torch.minimum(u1, u2)).sum(), (0.5 * verr * verr).sum(),
                       ent.sum(), b, vf_coef, ent_coef)
    return grads, metrics


def ppo_mlp_grads_agents_plain(params, packed, dirf, action, old_logp, adv, target, *,
                               clip_eps: float, vf_coef: float, ent_coef: float,
                               num_actions: int = 7, compute_dtype=torch.float32):
    """Plain version of the kernel's agent axis: :func:`ppo_mlp_grads_plain`
    agent by agent on ``params[k][i]`` and the agent's samples, the
    gradients stacked (N, ...) and each metric (N,)."""
    per = [ppo_mlp_grads_plain({k: v[i] for k, v in params.items()},
                               *(a[i] for a in (packed, dirf, action, old_logp, adv, target)),
                               clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef,
                               num_actions=num_actions, compute_dtype=compute_dtype)
           for i in range(packed.shape[0])]
    return ({k: torch.stack([g[k] for g, _ in per]) for k in per[0][0]},
            {k: torch.stack([m[k] for _, m in per]) for k in per[0][1]})


def ppo_mlp_grads(params, packed, dirf, action, old_logp, adv, target, *,
                  clip_eps: float, vf_coef: float, ent_coef: float,
                  num_actions: int = 7):
    """Gradients and metrics of the clipped-PPO loss of the mlp
    ``ActorCritic`` on packed cells.

    ``packed`` (B, C) int32; ``dirf`` (B, F) direction features without the
    bias column; ``action`` (B,) int; ``old_logp``, ``adv`` (normalized)
    and ``target`` (B,) float32. Returns ``(grads, metrics)``: flax-named
    float32 gradients like ``params``, and ``loss``, ``pg_loss``,
    ``vf_loss``, ``entropy``. CUDA tensors launch the kernel; CPU tensors
    take the plain version in float32.
    """
    if packed.device.type == 'cpu':
        return ppo_mlp_grads_plain(
            params, packed, dirf, action, old_logp, adv, target,
            clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef,
            num_actions=num_actions, compute_dtype=torch.float32)
    if packed.dim() != 2:
        raise ValueError(f'packed cells must be (B, C), got {tuple(packed.shape)}')
    return _grads_cuda(params, packed, dirf, action, old_logp, adv, target, clip_eps,
                       vf_coef, ent_coef, num_actions, agents=False)


def ppo_mlp_grads_agents(params, packed, dirf, action, old_logp, adv, target, *,
                         clip_eps: float, vf_coef: float, ent_coef: float,
                         num_actions: int = 7):
    """:func:`ppo_mlp_grads` of N per-agent policies in one launch.

    ``params`` stacked, every leaf (N, ...); ``packed`` (N, B, C); ``dirf``
    (N, B, F); ``action``, ``old_logp``, ``adv`` (normalized within each
    agent) and ``target`` (N, B). Each agent's loss is a mean over its own B
    samples. Returns ``(grads, metrics)``: stacked (N, ...) gradients and
    (N,) metrics. CUDA tensors launch the kernel over all agents (the
    agents' blocks sum in another order than N single launches: equal to
    them within bf16 rounding, and from run to run); CPU tensors take the
    plain version in float32.
    """
    if packed.device.type == 'cpu':
        return ppo_mlp_grads_agents_plain(
            params, packed, dirf, action, old_logp, adv, target,
            clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef,
            num_actions=num_actions, compute_dtype=torch.float32)
    if packed.dim() != 3:
        raise ValueError(f'packed cells must be (N, B, C), got {tuple(packed.shape)}')
    return _grads_cuda(params, packed, dirf, action, old_logp, adv, target, clip_eps,
                       vf_coef, ent_coef, num_actions, agents=True)


def _grads_cuda(params, packed, dirf, action, old_logp, adv, target, clip_eps, vf_coef,
                ent_coef, num_actions, agents: bool):
    """Launch the loss kernel, its partials' sum and the gradient kernel on
    CUDA tensors, with the agent axis where ``agents`` (counts once)."""
    global launches
    dev = packed.device
    n = packed.shape[0] if agents else 1
    lead = (n,) if agents else ()
    b, c = packed.shape[-2:]
    f = dirf.shape[-1]
    h = params['img_kernel'].shape[-1]
    if not supports(b, h, num_actions) or f > MAX_FEATURES:
        raise ValueError(f'ppo_loss kernel does not take batch {b}, hidden {h}, '
                         f'{num_actions} actions, {f} direction features')
    bf16, f32 = torch.bfloat16, torch.float32

    def w(name, dtype):
        t = params[name].detach().to(dtype).contiguous()
        return t.clone() if t.data_ptr() % 16 else t  # 16-byte rows in the kernel

    wd = torch.cat([params['Dense_0.kernel'], params['Dense_0.bias'][..., None, :]], -2)
    weights = [w('img_kernel', bf16), wd.detach().to(bf16).contiguous(),
               w('Dense_1.kernel', bf16), w('Dense_1.bias', f32),
               w('Dense_2.kernel', bf16), w('Dense_2.bias', f32),
               w('Dense_3.kernel', bf16), w('Dense_3.bias', f32)]
    shapes = [(c * NCH, h), (f + 1, h), (h, h), (h,), (h, num_actions),
              (num_actions,), (h, 1), (1,)]
    ptrs = [check_cuda(packed, 'packed', lead + (b, c), torch.int32),
            check_cuda(dirf, 'dirf', lead + (b, f), f32),
            check_cuda(action, 'action', lead + (b,), torch.int32),
            check_cuda(old_logp, 'old_logp', lead + (b,), f32),
            check_cuda(adv, 'adv', lead + (b,), f32),
            check_cuda(target, 'target', lead + (b,), f32)]
    ptrs += [check_cuda(t, 'weights', lead + s, t.dtype) for t, s in zip(weights, shapes)]
    # One block's partial sums: dW1, db1, [dW0; db0], dWa (H, 8), dwv, dba
    # (8), dbv and the three loss sums.
    sizes = [h * h, h, (f + 1) * h, 8 * h, h, 8, 1, 3]
    p = sum(sizes)
    # Every agent its own persistent blocks, all agents' in one wave.
    blocks = min(-(-b // TILE), max(1, fused_linear.sm_count(dev) // n))
    dx1 = torch.empty(lead + (b, h), dtype=bf16, device=dev)
    partial = torch.empty((n, blocks, p), dtype=f32, device=dev)
    sums = torch.empty(lead + (p,), dtype=f32, device=dev)
    inv_b = 1.0 / b
    with torch.cuda.device(dev):
        err = _lib_fn(agents)(
            *ptrs, dx1.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            *((n,) if agents else ()), b, c, f, num_actions, h, blocks,
            inv_b, ent_coef * inv_b, vf_coef * inv_b, 1.0 - clip_eps,
            1.0 + clip_eps, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ppo_loss kernel launch failed: error {err}')
    d_img = fused_linear.grad_w_cuda(packed, dx1)
    launches += 1

    dw1, db1, dwd, dwa, dwv, dba, dbv, loss_sums = torch.split(sums, sizes, -1)
    dw1, dwd, dwa = (dw1.unflatten(-1, (h, h)), dwd.unflatten(-1, (f + 1, h)),
                     dwa.unflatten(-1, (h, 8)))
    grads = {
        'img_kernel': d_img,
        'Dense_0.kernel': dwd[..., :f, :], 'Dense_0.bias': dwd[..., f, :],
        'Dense_1.kernel': dw1, 'Dense_1.bias': db1,
        'Dense_2.kernel': dwa[..., :num_actions], 'Dense_2.bias': dba[..., :num_actions],
        'Dense_3.kernel': dwv[..., None], 'Dense_3.bias': dbv,
    }
    return grads, _metrics(*loss_sums.unbind(-1), b, vf_coef, ent_coef)
