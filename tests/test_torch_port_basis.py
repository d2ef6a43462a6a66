"""The basis flavor of the training backward (kernel K6b through its plain
version on the CPU): the same moments as K2 through six raw tile-local sums
per instance and their binomial recombination.

- against K2's plain version in float64 (1e-9 of max |d fields|: the two
  formulations differ only by rounding);
- against the JAX package's ``_blend_train_bwd`` with ``USE_BASIS_BWD`` set,
  in interpret mode, at one shape in float64 (1e-9 of max |d fields|) and
  in float32.  In float32 the recombination cancels terms up to ~31^2 times
  its result: each formulation lands ~2e-5 of max from the float64 truth
  (measured: the JAX kernel 2.2e-5, the port 2.1e-5, where K2 of either
  package lands 3e-7), in different directions, since the sums run in
  different orders, so the two agree to 1e-4;
- ``render()`` under ``CGT_BLEND_FLAVOR=basis`` routes the training
  channel set through it and refuses a differentiable render of another
  channel set.
"""
import numpy as np
import pytest
import torch

from curve_gaussian_tpu.ops import rasterize_pallas as jrp

from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops.render import render as prender
from test_torch_port_blend import _case, _jax_blend, _scene
from test_torch_port_cull_cases import slots_table
from test_torch_port_geometry import assert_close, cam_pair, exact_sort, jax_x64, tt


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


def _inputs(H, W, dtype):
    _, ppre, jb, _, gc, gtt = _case(H, W, dtype)
    fields = prc.stack_fields(ppre)
    gidx, counts = tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32)
    col, finT = prc.blend_train_fwd_plain(fields, gidx, counts, torch.zeros(1, dtype=fields.dtype),
                                          H, W)
    return fields, gidx, counts, col, finT, tt(gc, fields.dtype), tt(gtt, fields.dtype)


@pytest.mark.parametrize("H,W", [(64, 64), (64, 96)])
def test_basis_plain_equals_moment_plain_float64(H, W):
    args = _inputs(H, W, np.float64)
    fields = args[0]
    slots = torch.from_numpy(slots_table(args[1], args[2], fields.shape[0]))
    d_basis = prc.moments_to_dfields(prc.blend_train_bwd_basis(*args, slots), fields)
    d_k2 = prc.moments_to_dfields(prc.blend_train_bwd(*args, slots), fields)
    assert_close(d_basis, d_k2.numpy(), 1e-9, "basis against K2")
    assert float(d_k2.abs().max()) > 0
    assert prc.blend_train_bwd_basis.launches == 0


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_basis_against_jax_basis_kernel(monkeypatch, dtype, tol):
    """64x64: the JAX basis kernel in interpret mode."""
    H = W = 64
    monkeypatch.setattr(jrp, "USE_BASIS_BWD", True)
    jpre, ppre, jb, jfields, gc, gtt = _case(H, W, dtype, seed=4)
    _, _, jd, jdbg = _jax_blend(jb, jfields, gc, gtt, H, W)
    fields = prc.stack_fields(ppre).detach().requires_grad_(True)
    bg = torch.zeros(1, dtype=fields.dtype, requires_grad=True)
    gidx, counts = tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32)
    slots = torch.from_numpy(slots_table(gidx, counts, fields.shape[0]))
    col, fin = prc.blend_train(fields, gidx, counts, slots, bg, H, W, basis=True)
    torch.autograd.backward((col, fin), (tt(gc, None), tt(gtt, None)))
    assert_close(fields.grad, jd, tol, "d fields")
    assert_close(bg.grad, jdbg, tol, "d bg")


def test_render_routes_the_basis_flavor(monkeypatch):
    H, W, P = 64, 96, 180
    xyz, scale, q, opa = (tt(a).requires_grad_(True) for a in _scene(3, P, np.float64))
    _, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(H, W)))
    kw = dict(capacity=136, big_capacity=64)
    grads = {}
    for flavor in ("", "basis"):
        monkeypatch.setenv("CGT_BLEND_FLAVOR", flavor)
        out = prender(xyz, scale, q, opa, pc, render_geo=False, compute_invdepth=False, **kw)
        grads[flavor] = torch.autograd.grad((out["render"] * g).sum(), (xyz, scale, q, opa))
    for a, b in zip(grads["basis"], grads[""]):
        assert_close(a, b.numpy(), 1e-9, "basis flavor gradient")
    # the basis backward exists only for the training channel set
    with pytest.raises(ValueError, match="training channel set"):
        prender(xyz, scale, q, opa, pc, **kw)
    with torch.no_grad():  # a render without gradients runs K3 alone
        assert prender(xyz, scale, q, opa, pc, **kw)["render"].shape == (H, W)
