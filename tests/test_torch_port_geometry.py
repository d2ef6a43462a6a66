"""Parity of the PyTorch port's geometry with the JAX package: quaternions,
curve sampling, the curve state's Gaussians (straight-through mask) and the
EWA preprocess, values and gradients, plus the helpers the other
``test_torch_port_*`` files share.

Both sides run in float64 (``jax_enable_x64`` for this module), so the
comparison tests the math; the JAX package keeps a few float32 constants
even then (the Bézier basis, the camera matrices built by
``look_at_camera``), and the port is handed the same ones.  Each array is
compared as ``port / max|jax|``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.models import curve_state as jcs
from curve_gaussian_tpu.ops import bezier as jbez
from curve_gaussian_tpu.ops import binning as jbin
from curve_gaussian_tpu.ops import knn as jknn
from curve_gaussian_tpu.ops import projection as jproj
from curve_gaussian_tpu.ops import quaternion as jq
from curve_gaussian_tpu.ops.camera import look_at_camera as j_look_at

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import bezier as pbez
from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops import knn as pknn
from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import quaternion as pq
from curve_gaussian_tpu_torch.ops.camera import Camera as PCamera

# float64 on both sides: what remains is summation order and the libm
F64_TOL = 1e-10
# float32 on both sides: a few ulps of float32 (6e-8) per operation chain
F32_TOL = 2e-5


# ---------------------------------------------------------------------------
# shared helpers (imported by the other test_torch_port_* modules)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def jax_x64():
    old = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def exact_sort():
    """SORT_PACKED=False on both sides (the conftest exact_depth_sort pin,
    at module scope) plus f32 moment scratch in the JAX backward."""
    from curve_gaussian_tpu.ops import rasterize_pallas as jrp

    old = (jbin.SORT_PACKED, pbin.SORT_PACKED, jrp.BWD_SCR_BF16, jrp.BWD_ACC_BF16)
    jbin.SORT_PACKED = pbin.SORT_PACKED = False
    jrp.BWD_SCR_BF16 = jrp.BWD_ACC_BF16 = False
    try:
        yield
    finally:
        jbin.SORT_PACKED, pbin.SORT_PACKED, jrp.BWD_SCR_BF16, jrp.BWD_ACC_BF16 = old


def tt(a, dtype=torch.float64):
    """numpy (or JAX) array -> CPU torch tensor of `dtype` (None keeps it)."""
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def rel_err(port, ref) -> float:
    """max |port - ref| / max |ref| (absolute when ref is all zero)."""
    p = np.asarray(port.detach().cpu().numpy() if torch.is_tensor(port) else port, np.float64)
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    d = np.abs(p - r).max() if p.size else 0.0
    m = np.abs(r).max() if r.size else 0.0
    return float(d / m) if m > 0 else float(d)


def assert_close(port, ref, tol, name=""):
    e = rel_err(port, ref)
    assert e <= tol, f"{name}: max error {e:.3g} of max|ref| > {tol:g}"


def cam_pair(eye, target, H, W, dtype=np.float64):
    """The same view for both packages: the JAX look_at camera (float32
    matrices) and a port Camera holding those matrices in `dtype`."""
    jc = j_look_at(eye=np.asarray(eye, float), target=np.asarray(target, float), height=H, width=W)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jc = dataclasses.replace(
        jc,
        world_to_cam=jnp.asarray(jc.world_to_cam, jdt),
        full_proj=jnp.asarray(jc.full_proj, jdt),
        cam_center=jnp.asarray(jc.cam_center, jdt),
    )
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pc = PCamera(
        world_to_cam=tt(jc.world_to_cam, tdt), full_proj=tt(jc.full_proj, tdt),
        cam_center=tt(jc.cam_center, tdt), height=H, width=W,
        tanfovx=jc.tanfovx, tanfovy=jc.tanfovy,
    )
    return jc, pc


def random_curves(rng, C, n_lines, spread=0.25, half=0.15, jitter=0.03):
    """C curves near the origin (the last n_lines straight) as numpy."""
    pts = rng.uniform(-spread, spread, size=(C, 3))
    d = np.stack([np.zeros(C), np.full(C, half), np.zeros(C)], -1)
    cp = np.stack([pts - d, pts - 0.5 * d, pts + 0.5 * d, pts + d], 1)
    cp = cp + rng.normal(0, jitter, size=cp.shape)
    is_bez = np.arange(C) < C - n_lines
    return cp, is_bez


def state_arrays(rng, C, M, n_lines=2, n_dead=0, **kw):
    """numpy leaves of a CurveState (trainable dict, is_bezier, alive)."""
    cp, is_bez = random_curves(rng, C, n_lines, **kw)
    params = {
        "curve_points": cp,
        "opacity_raw": np.log(1 / rng.uniform(0.4, 0.8, C) - 1) * -1.0,
        "width_raw": np.log(np.full(C, 0.012) * rng.uniform(0.5, 2.0, C)),
        "mask_raw": rng.normal(1.0, 2.5, size=(C, M)),
        "features_dc": np.zeros((C, M, 1)),
        "exposure": np.tile([1.0, 0.0], (1, 1)),
    }
    alive = np.arange(C) < C - n_dead
    return params, is_bez, alive


def jax_state(params, is_bez, alive, dtype=jnp.float64):
    return jcs.CurveState(
        **{k: jnp.asarray(v, dtype) for k, v in params.items()},
        is_bezier=jnp.asarray(is_bez), alive=jnp.asarray(alive),
    )


# ---------------------------------------------------------------------------
# module setup
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _x64():
    with jax_x64():
        yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quat_to_rotmat(rng, dtype):
    q = rng.normal(size=(64, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)
    ref = np.asarray(jq.quat_to_rotmat(jnp.asarray(q)))
    out = pq.quat_to_rotmat(tt(q, None))
    assert out.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert_close(out, ref, F64_TOL if dtype == np.float64 else F32_TOL, "rotmat")
    # the rest of the module: round trip and rotation of points
    rq = np.asarray(jq.rotmat_to_quat(jnp.asarray(ref)))
    assert_close(pq.rotmat_to_quat(tt(ref, None)), rq, 1e-6, "rotmat_to_quat")
    p = rng.normal(size=(64, 3)).astype(dtype)
    assert_close(pq.rotate_by_quat(tt(q, None), tt(p, None)),
                 np.asarray(jq.rotate_by_quat(jnp.asarray(q), jnp.asarray(p))),
                 1e-6, "rotate_by_quat")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_curve_gaussians_values_and_grads(rng, dtype):
    """Béziers and lines (rows 1-2 of a line hold stale values that must be
    ignored), with gradients of a random functional of every output."""
    C, M = 10, 7
    cp, is_bez = random_curves(rng, C, 4)
    cp[~is_bez, 1:3] += 5.0  # stale interior rows of the lines
    cp = cp.astype(dtype)
    width = rng.uniform(0.005, 0.02, C).astype(dtype)
    outs = ("xyz", "quat", "scale", "tangent")
    cot = {k: rng.normal(size=(C, M, 4 if k == "quat" else 3)).astype(dtype) for k in outs}

    def jf(c, w):
        g = jbez.curve_gaussians(c, w, jnp.asarray(is_bez), M)
        return sum(jnp.sum(g[k] * cot[k]) for k in outs), g

    (jval, jg), jgrad = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cp), jnp.asarray(width))
    c_t = tt(cp, None).requires_grad_(True)
    w_t = tt(width, None).requires_grad_(True)
    g = pbez.curve_gaussians(c_t, w_t, tt(is_bez, torch.bool), M)
    val = sum((g[k] * tt(cot[k], None)).sum() for k in outs)
    val.backward()
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    for k in outs:
        assert_close(g[k], np.asarray(jg[k]), tol, k)
    assert_close(c_t.grad, np.asarray(jgrad[0]), tol * 10, "d curve_points")
    assert_close(w_t.grad, np.asarray(jgrad[1]), tol * 10, "d width")


def test_tangent_frame_and_helpers(rng):
    t = rng.normal(size=(32, 3))
    t[0] = [0.0, 0.0, 2.0]  # parallel to the primary up vector
    t[1] = 0.0  # degenerate
    assert_close(pbez.tangent_frame(tt(t)), np.asarray(jbez.tangent_frame(jnp.asarray(t))),
                 F64_TOL, "tangent_frame")
    assert_close(pbez.safe_normalize(tt(t)), np.asarray(jbez.safe_normalize(jnp.asarray(t))),
                 F64_TOL, "safe_normalize")
    assert_close(pbez.sample_t_midpoints(7, torch.float64),
                 np.asarray(jbez.sample_t_midpoints(7, jnp.float64)), 0.0, "t")
    b = rng.uniform(0.1, 0.3, 32)
    assert_close(pbez.initialize_bezier_curves(tt(t), tt(b)),
                 np.asarray(jbez.initialize_bezier_curves(jnp.asarray(t), jnp.asarray(b))),
                 0.0, "initialize_bezier_curves")


def test_knn_and_init_state(rng):
    pts = rng.uniform(0, 1, size=(300, 3))
    assert_close(pknn.mean_knn_sq_dist(tt(pts), k=3, chunk=128),
                 np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts), k=3, chunk=128)),
                 1e-9, "knn")
    js = jcs.init_state(pts, n_views=3, n_gaussians=5, dtype=jnp.float64)
    ps = pcs.init_state(pts, n_views=3, n_gaussians=5, dtype=torch.float64, device="cpu")
    assert ps.capacity == js.capacity == pcs.round_capacity(300) == 512
    for k in pcs.TRAINABLE_FIELDS + ("is_bezier", "alive"):
        assert_close(getattr(ps, k), np.asarray(getattr(js, k)), 1e-9, k)


@pytest.mark.parametrize("use_mask", [False, True])
def test_gaussians_straight_through_mask(rng, use_mask):
    """gaussians() values and the gradients through the straight-through
    mask (the hard 0/1 gate passes the sigmoid's gradient)."""
    C, M = 8, 6
    params, is_bez, alive = state_arrays(rng, C, M, n_dead=2)
    params["mask_raw"][0, :3] = -8.0  # below mask_threshold: gated off
    keys = ("curve_points", "opacity_raw", "width_raw", "mask_raw")
    outs = ("xyz", "scale", "quat", "opacity", "tangent")
    cot = {k: rng.normal(size=(C * M,) + ((3,) if k != "quat" and k != "opacity" else
                                          (4,) if k == "quat" else ())) for k in outs}

    def jf(*vals):
        st = dataclasses.replace(jax_state(params, is_bez, alive), **dict(zip(keys, vals)))
        g = jcs.gaussians(st, use_mask=use_mask)
        return sum(jnp.sum(g[k] * cot[k]) for k in outs), g

    (_, jg), jgrad = jax.value_and_grad(jf, argnums=tuple(range(4)), has_aux=True)(
        *(jnp.asarray(params[k], jnp.float64) for k in keys))
    ps = convert.state_from_numpy(params, is_bez, alive, device="cpu", dtype=torch.float64)
    for k in keys:
        getattr(ps, k).requires_grad_(True)
    g = pcs.gaussians(ps, use_mask=use_mask)
    sum((g[k] * tt(cot[k])).sum() for k in outs).backward()
    for k in outs + ("alive",):
        assert_close(g[k], np.asarray(jg[k]), F64_TOL, k)
    for k, jgr in zip(keys, jgrad):
        t = getattr(ps, k)
        grad = t.grad if t.grad is not None else torch.zeros_like(t)  # mask_raw unused
        assert_close(grad, np.asarray(jgr), 1e-9, f"d {k}")


def _preprocess_inputs(rng, P, dtype):
    xyz = rng.uniform(-0.6, 0.6, size=(P, 3))
    xyz[:4, 2] = -2.0  # behind the near plane of a camera at z=-1.8
    xyz[4:8, 0] = rng.choice([-3.0, 3.0], 4)  # outside 1.3 tanfov: the clamp
    scale = np.stack([rng.uniform(0.01, 0.08, P), rng.uniform(0.002, 0.02, P),
                      rng.uniform(0.002, 0.02, P)], -1)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opa = rng.uniform(0.05, 0.95, P)
    alive = rng.uniform(size=P) > 0.1
    return [a.astype(dtype) for a in (xyz, scale, q, opa)] + [alive]


@pytest.mark.parametrize("dtype,antialiasing", [
    (np.float64, False), (np.float64, True), (np.float32, False),
])
def test_preprocess_values_and_grads(rng, dtype, antialiasing):
    P, H, W = 96, 48, 64
    xyz, scale, q, opa, alive = _preprocess_inputs(rng, P, dtype)
    jc, pc = cam_pair([0.1, 0.2, -1.8], [0, 0, 0], H, W, dtype)
    cot = [rng.normal(size=s).astype(dtype) for s in ((P, 2), (P, 3), (P,), (P,))]

    def jf(x, s, qq, o):
        pre = jproj.preprocess(x, s, qq, o, jc, antialiasing=antialiasing,
                               alive=jnp.asarray(alive))
        outs = (pre.mean2d, pre.conic, pre.depth, pre.opacity)
        return sum(jnp.sum(a * c) for a, c in zip(outs, cot)), pre

    (_, jpre), jgrad = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (xyz, scale, q, opa)))
    ins = [tt(a, None).requires_grad_(True) for a in (xyz, scale, q, opa)]
    pre = pproj.preprocess(*ins, pc, antialiasing=antialiasing, alive=tt(alive, torch.bool))
    outs = (pre.mean2d, pre.conic, pre.depth, pre.opacity)
    sum((a * tt(c, None)).sum() for a, c in zip(outs, cot)).backward()
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    for name in pproj.Preprocessed._fields:
        assert_close(getattr(pre, name), np.asarray(getattr(jpre, name)), tol, name)
    assert not bool(pre.valid[:4].any()), "near-plane cull"
    for name, t, jg in zip(("xyz", "scale", "quat", "opacity"), ins, jgrad):
        assert_close(t.grad, np.asarray(jg), tol * 10, f"d {name}")


def test_clip_gradient_tie_rule():
    """jnp.clip passes half the gradient at a bound, torch.clamp all of it;
    the port's clip (render's [0, 1] clip, the 1.3 tanfov clamp) follows
    JAX, which matters where empty pixels render exactly 0."""
    x = np.array([0.0, 0.5, 1.0, -0.2, 1.3])
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x)))
    xt = tt(x).requires_grad_(True)
    pproj.clip(xt, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    np.testing.assert_array_equal(jg, [0.5, 1.0, 0.5, 0.0, 0.0])
