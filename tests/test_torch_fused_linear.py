"""The first layer on packed cells ≡ the JAX package's fused_linear.

The plain versions of the forward and weight-gradient kernels are held
against the JAX kernels run in Pallas interpret mode, on the same numpy
inputs; the ``autograd.Function`` is held against its plain parts on the
CPU (where it launches nothing). The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multigrid_tpu.learn.nets import one_hot_image
from multigrid_tpu.ops import fused_linear as jax_fl
from multigrid_tpu_torch.ops import fused_linear as fl

torch.set_num_threads(1)

B, C, H = 64, 49, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cells = (rng.integers(0, 11, (B, C)) << 8) | (rng.integers(0, 6, (B, C)) << 4) \
        | rng.integers(0, 4, (B, C))
    cells[:, -3:] = fl.PAD_CELL  # pad cells match no channel
    cells[0, :5] = [11 << 8, 6 << 4, 4, -1, 0]  # fields past their channels
    w = (rng.normal(size=(C * fl.NCH, H)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, H)).astype(np.float32)
    return cells.astype(np.int32), w, g


def _jax_features(cells):
    return np.asarray(one_hot_image(jnp.asarray(cells), jnp.float32, packed=True)
                      ).reshape(B, C * fl.NCH)


def test_constants_match_jax():
    assert fl.NCH == jax_fl._NCH and fl.PAD_CELL == jax_fl._PAD_CELL


def test_forward_plain_matches_jax_kernel():
    """Interpret mode computes in f32 and rounds the output to bf16; the
    plain version rounds the weights to bf16 first, as the TPU and the CUDA
    kernels do. Both outputs are bf16: equal to 2 bf16 ulps of the weights'
    rounding (relative 2e-2, bench.py:54-55)."""
    cells, w, _ = _inputs(0)
    want = np.asarray(jax_fl.onehot_linear_packed(jnp.asarray(cells), jnp.asarray(w),
                                                  interpret=True), np.float32)
    got = fl.onehot_linear_plain(torch.as_tensor(cells), torch.as_tensor(w))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
    # Against the JAX expression with bf16 weights: the same rounding points.
    feats = _jax_features(cells)
    exact = feats @ np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got.float().numpy(), exact, rtol=8e-3, atol=1e-6)


def test_grad_plain_matches_jax_custom_vjp():
    """dW through the JAX custom VJP (the Pallas gradient kernel, interpret
    mode, g rounded to bf16) ≡ the plain dW: f32 sums of the same values."""
    cells, w, g = _inputs(1)

    def loss(w_):
        out = jax_fl.onehot_linear(jnp.asarray(cells), w_, True).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    got = fl.onehot_linear_grad_w_plain(torch.as_tensor(cells), torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_autograd_function_on_the_cpu():
    cells, w, g = _inputs(2)
    packed = torch.as_tensor(cells)
    wt = torch.as_tensor(w).requires_grad_(True)
    launches = fl.launches, fl.grad_launches
    out = fl.onehot_linear(packed, wt)
    assert torch.equal(out, fl.onehot_linear_plain(packed, wt.detach()))
    (out.float() * torch.as_tensor(g)).sum().backward()
    # The cotangent of a bf16 output is bf16: dW sums bf16(g).
    want = fl.onehot_linear_grad_w_plain(packed, torch.as_tensor(g).to(torch.bfloat16))
    torch.testing.assert_close(wt.grad, want, rtol=0, atol=0)
    assert (fl.launches, fl.grad_launches) == launches  # the CPU launches nothing
