"""Parity of the port's SSIM (kernels K7/K8 through their plain versions on
the CPU) with the JAX package.

float32: against ``ssim_pallas.ssim_fused`` in interpret mode, at the
tolerances of tests/test_ssim.py (atol 1e-5 on the value, 1e-6 on the
gradients): the fused kernels emulate float32 products with three bf16
passes (~22 bits), the port blurs in float32 tap by tap.  One image is
below the fused kernel's 128-row tile, one above it and ragged.

float64: against ``ssim.ssim``, which under x64 takes the banded-matmul
route (only float32 goes to the fused kernels); both sides use the same
float32-rounded window taps.  The port's ``ssim`` takes that route for
float64 too, so the fused pair's plain versions are held there through
``ssim_fused``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.ops import ssim as jssim
from curve_gaussian_tpu.ops import ssim_pallas as jsp

from curve_gaussian_tpu_torch.ops import ssim as pssim
from curve_gaussian_tpu_torch.ops import ssim_cuda as psc
from test_torch_port_geometry import assert_close, jax_x64, tt


@pytest.fixture(scope="module", autouse=True)
def _x64():
    with jax_x64():
        yield


def _pair(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(dtype)
    b = (0.5 * a + 0.5 * rng.uniform(size=shape) ** 3).astype(dtype)  # correlated
    return a, b


def _port(a, b, scale=1.0, fn=pssim.ssim):
    at = tt(a, None).requires_grad_(True)
    bt = tt(b, None).requires_grad_(True)
    v = fn(at, bt)
    (scale * v).backward()
    return v.detach(), at.grad, bt.grad


@pytest.mark.parametrize("shape", [(72, 60), (150, 70)])
def test_fused_float32(shape):
    a, b = _pair(shape, np.float32, shape[0])
    jv, (ja, jb) = jax.value_and_grad(jsp.ssim_fused, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    v, ga, gb = _port(a, b)
    assert v.dtype == torch.float32
    np.testing.assert_allclose(float(v), float(jv), atol=1e-5)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), atol=1e-6)
    assert psc.ssim_fwd.launches == 0 and psc.ssim_bwd.launches == 0


@pytest.mark.parametrize("shape", [(90, 77), (5, 7), (1, 33), (17, 300)])
def test_float64_matches_ssim(shape):
    """Also at the shapes that are ragged against the kernels' 32x32 tiles or
    smaller than the window."""
    a, b = _pair(shape, np.float64, 3)
    jv, (ja, jb) = jax.value_and_grad(lambda x, y: jssim.ssim(x, y), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    for fn in (pssim.ssim, psc.ssim_fused):  # the band-matrix path, K7/K8's plain versions
        v, ga, gb = _port(a, b, fn=fn)
        assert abs(float(v) - float(jv)) < 1e-12
        assert_close(ga, np.asarray(ja), 1e-10, "d img1")
        assert_close(gb, np.asarray(jb), 1e-10, "d img2")


def test_plain_backward_is_the_gradient():
    """The hand-derived K8 formula equals autograd of the plain K7 (float64),
    with an upstream scale."""
    a, b = _pair((40, 52), np.float64, 9)
    at = tt(a).requires_grad_(True)
    bt = tt(b).requires_grad_(True)
    (-0.3 * psc.ssim_fwd_plain(at, bt)).backward()
    d1, d2 = psc.ssim_bwd_plain(tt(a), tt(b), torch.tensor(-0.3, dtype=torch.float64))
    assert_close(d1, at.grad.numpy(), 1e-12, "d img1")
    assert_close(d2, bt.grad.numpy(), 1e-12, "d img2")
    assert float(pssim.ssim(tt(a), tt(a))) == pytest.approx(1.0, abs=1e-12)
    assert np.array_equal(pssim.gaussian_window(11), jssim.gaussian_window(11))
    assert (pssim.C1, pssim.C2) == (jssim.C1, jssim.C2)
