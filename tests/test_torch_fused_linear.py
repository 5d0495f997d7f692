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
import pytest
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


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """A library's key hashes the csrc headers its source includes, followed
    through the headers, so an edited header rebuilds every kernel that uses
    it; the first-layer and loss kernels share the tensor-core one-hot
    product, which includes the gather header that the policy kernel uses."""
    from multigrid_tpu_torch.utils import build
    for src in ('fused_linear.cu', 'fused_ppo.cu'):
        assert build.sources_of(src) == [src, 'onehot_mma.cuh', 'onehot_rows.cuh']
    assert build.sources_of('fused_policy.cu') == ['fused_policy.cu', 'onehot_rows.cuh']
    monkeypatch.setattr(build, 'CSRC_DIR', tmp_path)
    (tmp_path / 'k.cu').write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / 'a.cuh').write_text('#pragma once\n #  include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('// b\n')
    assert build.sources_of('k.cu') == ['k.cu', 'a.cuh', 'b.cuh']
    keys = [build.library_path('k.cu')]
    (tmp_path / 'b.cuh').write_text('// b, edited\n')
    keys.append(build.library_path('k.cu'))
    assert keys[0] != keys[1] and keys[1] == build.library_path('k.cu')


@pytest.mark.parametrize('h', [1, 7, 8, 100, 256])
def test_pad_columns_keeps_the_product(h):
    """The forward wrapper's zero columns (up to a multiple of 8, for the
    kernel's 16-byte row pieces) leave the first H columns of the product
    as they were, equal to the JAX kernel's (interpret mode)."""
    cells, _, _ = _inputs(3)
    rng = np.random.default_rng(h)
    w = (rng.normal(size=(C * fl.NCH, h)) * 0.1).astype(np.float32)
    wt = torch.as_tensor(w)
    padded = fl.pad_columns(wt)
    assert padded.shape == (C * fl.NCH, -(-h // 8) * 8)
    assert torch.equal(padded[:, :h], wt) and not padded[:, h:].any()
    assert (padded is wt) == (h % 8 == 0)
    got = fl.onehot_linear_plain(torch.as_tensor(cells), padded)
    assert not got[:, h:].float().any()
    assert torch.equal(got[:, :h], fl.onehot_linear_plain(torch.as_tensor(cells), wt))
    want = np.asarray(jax_fl.onehot_linear_packed(jnp.asarray(cells), jnp.asarray(w),
                                                  interpret=True), np.float32)
    np.testing.assert_allclose(got[:, :h].float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize('c', [9, 49, 196])
@pytest.mark.parametrize('b', [1, 255, 1001, 262144])
def test_grad_plan_covers_every_sample_once(b, c):
    """The gradient kernel's launch plan, on an H100's 132 SMs and on a
    smaller card: chunks of whole stages that cover ``[0, b)``
    exactly once, none empty, in one wave of blocks where the cell tiles
    leave room, and one partial slab for every chunk a sample falls in."""
    for h, sms in [(128, 132), (256, 132), (32, 20)]:
        chunks, chunk = fl.grad_plan(b, c, h, sms)
        assert chunks >= 1 and chunk % fl.GRAD_STAGE == 0
        starts = np.arange(chunks) * chunk
        ends = np.minimum(starts + chunk, b)
        assert (ends > starts).all()  # no chunk is empty
        covered = np.zeros(b, int)
        for s, e in zip(starts, ends):
            covered[s:e] += 1
        assert (covered == 1).all()
        tiles = -(-c // fl.GRAD_CELLS_PER_BLOCK) * -(-h // fl.GRAD_COLS_PER_BLOCK)
        assert tiles * chunks <= max(sms, tiles)
        # The wrapper sizes the partials by ``chunks``, one (C·21, H) slab
        # a chunk: every sample's chunk index has its slab.
        assert (np.arange(b) // chunk).max() == chunks - 1
