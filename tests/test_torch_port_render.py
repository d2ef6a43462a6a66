"""Parity of the port's full-channel render path with the JAX package:
``rasterize_reference``, ``render`` in every channel configuration and
blend flavor and with ``backend="reference"``, ``eval_render``,
``make_scene`` and the ``pairs`` binning.

The JAX side renders through its oracle (``backend="reference"``), whose
interpret-free autodiff costs ~2 s where an interpret-mode Pallas render
costs ~15 s; the per-splat colour set (T, T, F) is also held against the
JAX render with its Pallas kernels in interpret mode (K3 and K4 of that
set).  Kernel and oracle agree to float64 rounding: the same compositing
rules, tile membership and clamp (straight-through in the oracle, the
hand-derived backward in the kernels).  Everything runs in float64 except
``make_scene``, which is float32 on both sides.
"""
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.config import PipelineConfig as JPipe
from curve_gaussian_tpu.data import synthetic as jsyn
from curve_gaussian_tpu.engine import train as jtrain
from curve_gaussian_tpu.ops import binning as jbin
from curve_gaussian_tpu.ops import projection as jproj
from curve_gaussian_tpu.ops import rasterize_ref as jref
from curve_gaussian_tpu.ops.render import main_axis_allmap as j_main_axis_allmap
from curve_gaussian_tpu.ops.render import render as jrender

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import rasterize_ref as pref
from curve_gaussian_tpu_torch.ops.render import main_axis_allmap
from curve_gaussian_tpu_torch.ops.render import render as prender
from test_torch_port_binning import CASES, _pre_pair
from test_torch_port_binning import _scene as _bin_scene
from test_torch_port_blend import _scene
from test_torch_port_geometry import (assert_close, cam_pair, exact_sort, jax_state, jax_x64,
                                      state_arrays, tt)
from test_torch_port_step import _numpy_ts

H, W, P = 64, 96, 180
K = 128  # a multiple of 64: the JAX forward reads 64-instance groups
F64_TOL = 1e-9
# float32 (make_scene on both sides): the render's float32 rounding, about
# 1e-6 after a pixel's few dozen contributions, scaled by the 1 +- noise
# jitter
F32_TOL = 1e-5
OUTS = ("render", "invdepth", "final_T", "alpha", "dir")
TELEMETRY = ("radii", "visibility", "overflow", "tile_peak", "big_peak", "big_overflow")
GRADS = ("xyz", "scale", "quat", "opacity", "color", "bg", "exposure")


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


@contextlib.contextmanager
def _x32():
    old = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _inputs(dtype):
    xyz, scale, q, opa = _scene(3, P, dtype)
    rng = np.random.default_rng(11)
    color = rng.uniform(0.2, 1.0, P).astype(dtype)
    ks = [rng.normal(size=s).astype(dtype) for s in ((H, W), (H, W), (H, W), (3, H, W))]
    expo = np.array([1.3, 0.0], dtype)  # offset 0 keeps empty pixels at exactly 0
    return [xyz, scale, q, opa, color, np.zeros((), dtype), expo], ks


def _loss(out, ks, invd: bool):
    """sum(render k1 + invdepth k2 + alpha k3 + dir k4), the invdepth term
    only where the configuration renders it."""
    terms = [out["render"] * ks[0], out["alpha"] * ks[2], out["dir"] * ks[3]]
    if invd:
        terms.append(out["invdepth"] * ks[1])
    return sum(t.sum() for t in terms)


_REF = {}


def _jax_render(geo, invd, with_color, dtype, backend="reference"):
    """The JAX render's outputs and its gradients to every input (cached)."""
    key = (geo, invd, with_color, np.dtype(dtype).name, backend)
    if key not in _REF:
        args, ks = _inputs(dtype)
        jc, _ = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W, dtype)

        def f(x, s, q, o, c, bg, ex):
            out = jrender(x, s, q, o, jc, bg=bg, color=c if with_color else None, exposure=ex,
                          render_geo=geo, compute_invdepth=invd, capacity=K, big_capacity=64,
                          backend=backend)
            return _loss(out, ks, invd), out

        (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(7)), has_aux=True)(
            *map(jnp.asarray, args))
        _REF[key] = ({k: np.asarray(v) for k, v in out.items()},
                     dict(zip(GRADS, map(np.asarray, grads))))
    return _REF[key]


def _port_render(geo, invd, with_color, dtype, backend="pallas"):
    args, ks = _inputs(dtype)
    _, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W, dtype)
    ts = [tt(a, None).requires_grad_(True) for a in args]
    x, s, q, o, c, bg, ex = ts
    out = prender(x, s, q, o, pc, bg=bg, color=c if with_color else None, exposure=ex,
                  render_geo=geo, compute_invdepth=invd, capacity=K, big_capacity=64,
                  backend=backend)
    invd_term = invd or backend == "reference"  # the oracle always renders invdepth
    _loss(out, [tt(k, None) for k in ks], invd_term).backward()
    grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t)) for n, t in zip(GRADS, ts)}
    return out, grads


def _compare(out, grads, ref, ref_grads, fwd_tol, bwd_tol, invd):
    for k in OUTS:
        if k == "invdepth" and not invd:  # the kernels gate it; the oracle renders it
            assert float(out[k].detach().abs().max()) == 0.0
            continue
        assert_close(out[k], ref[k], fwd_tol, k)
    for k in TELEMETRY:
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    for k in GRADS:
        assert_close(grads[k], ref_grads[k], bwd_tol, f"d {k}")


# name: (render_geo, compute_invdepth, per-splat colour, CGT_BLEND_FLAVOR, backend)
CONFIGS = {
    "eval": (True, True, False, "", "pallas"),
    "eval_reference": (True, True, False, "", "reference"),
    "colour": (True, True, True, "", "pallas"),
    "geo": (True, False, False, "", "pallas"),
    "geo_colour": (True, False, True, "", "pallas"),
    "invd": (False, True, False, "", "pallas"),
    "invd_colour": (False, True, True, "", "pallas"),
    "colour_only": (False, False, True, "", "pallas"),
    "train": (False, False, False, "", "pallas"),
    "train_flavor_train": (False, False, False, "train", "pallas"),
    "train_flavor_table": (False, False, False, "table", "pallas"),
    "train_flavor_indirect": (False, False, False, "indirect", "pallas"),
    "train_reference": (False, False, False, "", "reference"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_configuration(name, monkeypatch):
    """render() against the JAX oracle render: the output dict and the
    gradients to xyz, scale, quat, opacity, colour, bg and exposure."""
    geo, invd, colour, flavor, backend = CONFIGS[name]
    monkeypatch.setenv("CGT_BLEND_FLAVOR", flavor)
    ref, ref_grads = _jax_render(geo, invd or backend == "reference", colour, np.float64)
    out, grads = _port_render(geo, invd, colour, np.float64, backend)
    _compare(out, grads, ref, ref_grads, F64_TOL, F64_TOL, invd or backend == "reference")
    img = out["render"].detach().numpy()
    assert (img == 0).sum() > 0 and (img > 0).sum() > 0
    assert float(np.abs(ref_grads["opacity"]).max()) > 0
    assert (float(np.abs(ref["alpha"]).max()) > 0) == geo


def test_render_colour_against_kernels():
    """(T, T, F), a per-splat colour, against the JAX render through its
    Pallas kernels (K3 and K4 in interpret mode)."""
    ref, ref_grads = _jax_render(True, True, True, np.float64, backend="pallas")
    out, grads = _port_render(True, True, True, np.float64)
    _compare(out, grads, ref, ref_grads, F64_TOL, F64_TOL, True)
    assert float(np.abs(ref_grads["color"]).max()) > 0


def test_unknown_flavor_and_backend_raise(monkeypatch):
    args, _ = _inputs(np.float64)
    _, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W)
    x, s, q, o = (tt(a) for a in args[:4])
    monkeypatch.setenv("CGT_BLEND_FLAVOR", "fast")
    with pytest.raises(ValueError, match="CGT_BLEND_FLAVOR"):
        prender(x, s, q, o, pc, capacity=K)
    # the oracle backend never reads the flavor, as in the JAX package
    out = prender(x, s, q, o, pc, capacity=K, backend="reference")
    assert float(out["render"].max()) > 0
    monkeypatch.setenv("CGT_BLEND_FLAVOR", "")
    with pytest.raises(ValueError, match="backend"):
        prender(x, s, q, o, pc, capacity=K, backend="pallas_table")


@pytest.mark.parametrize("tiles", [True, False])
def test_rasterize_reference(tiles):
    """rasterize_reference itself with the binning's tile membership and
    without it (every valid Gaussian a candidate everywhere), and
    depth_order.  Its gradients are held through ``render(backend=
    "reference")`` in test_render_configuration."""
    args, _ = _inputs(np.float64)
    xyz, scale, q, opa, color = args[:5]
    jc, _ = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W)
    alive = np.arange(P) % 19 != 4
    jpre = jproj.preprocess(*map(jnp.asarray, (xyz, scale, q, opa)), jc, alive=jnp.asarray(alive))
    allmap = np.asarray(j_main_axis_allmap(jnp.asarray(xyz), jnp.asarray(q), jc))
    member = jref.membership(jbin.bin_gaussians(jpre, H, W, capacity=K, big_capacity=64), P) \
        if tiles else None

    jout = jref.rasterize_reference(jpre, jnp.asarray(color), jnp.asarray(allmap),
                                    jnp.asarray(0.2), H, W, member=member)
    ppre = pproj.Preprocessed(*(tt(a, None) for a in jpre))
    out = pref.rasterize_reference(ppre, tt(color), tt(allmap), tt(0.2), H, W,
                                   member=None if member is None else tt(member, torch.bool))
    for k in ("render", "invdepth", "final_T", "allmap"):
        assert_close(out[k], np.asarray(jout[k]), F64_TOL, k)
    assert float(np.asarray(jout["final_T"]).min()) < 1e-3
    order = pref.depth_order(ppre)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jref.depth_order(jpre)))


def test_eval_render_of_a_carried_state():
    """eval_render of a TrainState carried across by
    ``convert.train_state_from_numpy``, with the mask and the learned
    exposure of view 1, against the JAX eval_render (oracle backend)."""
    C, M = 8, 6
    params, is_bez, alive = state_arrays(np.random.default_rng(0), C, M, n_dead=1)
    params["exposure"] = np.array([[1.0, 0.0], [1.2, 0.03]])
    params["mask_raw"][2, :3] = -7.0  # gated off by the hard mask
    s = _numpy_ts(jtrain.init_train_state(jax_state(params, is_bez, alive)))
    jc, pc = cam_pair([0.0, 0.2, -1.8], [0, 0, 0], H, W)
    kw = dict(use_mask=True, use_exposure=True)
    jout = jtrain.eval_render(jtrain.init_train_state(jax_state(params, is_bez, alive)), jc,
                              JPipe(tile_capacity=K, backend="reference"), jnp.asarray(0.0),
                              view_idx=jnp.asarray(1), n_gaussians=M, **kw)
    ts = convert.train_state_from_numpy(
        s["params"], s["mu"], s["nu"], s["count"], s["is_bezier"], s["alive"],
        s["xyz_grad_accum"], s["denom"], s["max_radii"], s["step"], s["opacity_frozen"],
        device="cpu", dtype=torch.float64)
    pipe = PipelineConfig(tile_capacity=K)
    with torch.no_grad():
        out = ptrain.eval_render(ts, pc, pipe, 0.0, view_idx=1, **kw)
    for k in OUTS:
        assert_close(out[k], np.asarray(jout[k]), F64_TOL, k)
    for k in TELEMETRY:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert float(out["alpha"].max()) > 0.5 and float(out["render"].max()) > 0.5
    with pytest.raises(ValueError, match="exposure"):
        ptrain.eval_render(ts, pc, pipe, 0.0, use_exposure=True)
    # differentiable, as the JAX function is
    ts.params["curve_points"].requires_grad_(True)
    ptrain.eval_render(ts, pc, pipe, 0.0, **dict(kw, use_exposure=False))["alpha"].sum().backward()
    assert float(ts.params["curve_points"].grad.abs().max()) > 0


def test_make_scene_with_noise():
    """make_scene in float32 at 2 views of 64x64 with noise: the same
    curves and the same noise draws as the JAX make_scene (float32, oracle
    backend), edge maps within F32_TOL."""
    kw = dict(seed=3, n_curves=3, n_lines=1, n_views=2, height=64, width=64, noise=0.2,
              samples_per_curve=24, capacity=K)
    with _x32():
        js = jsyn.make_scene(backend="reference", **kw)
    ps = psyn.make_scene(device="cpu", **kw)
    np.testing.assert_array_equal(ps.curves, js.curves)
    np.testing.assert_array_equal(ps.is_bezier, js.is_bezier)
    assert len(ps.edge_maps) == len(ps.cameras) == 2
    for pm, jm in zip(ps.edge_maps, js.edge_maps):
        assert pm.dtype == torch.float32 and pm.shape == (64, 64)
        np.testing.assert_allclose(pm.numpy(), jm, rtol=0, atol=F32_TOL)
        assert 0.0 <= float(pm.min()) and float(pm.max()) <= 1.0 and float(pm.max()) > 0.5
    clean = psyn.make_scene(device="cpu", **dict(kw, noise=0.0))
    assert float((clean.edge_maps[0] - ps.edge_maps[0]).abs().max()) > 0.01


def test_pairs_binning():
    """bin_gaussians(method="pairs"): tables and telemetry equal to the JAX
    pairs construction (which has no big tier), on a scene that overflows
    the per-tile capacity and the per-Gaussian rect; and the same tables as
    the sort method's exact key, given a big tier that holds every wide
    Gaussian."""
    Hb, Wb, sk, bk = CASES["overflow"]
    jpre, ppre = _pre_pair(_bin_scene(sorted(CASES).index("overflow"), dtype=np.float32, **sk),
                           Hb, Wb, np.float32)
    kw = dict(capacity=bk["capacity"], max_rect=bk["max_rect"], method="pairs")
    jb = jbin.bin_gaussians(jpre, Hb, Wb, **kw)
    pb = pbin.bin_gaussians(ppre, Hb, Wb, **kw)
    for f in ("gather_idx", "slot_valid", "counts", "overflow", "peak", "big_count",
              "big_overflow"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    assert int(pb.counts.sum()) > 0 and pb.gather_idx.dtype == torch.int32
    assert int(pb.peak) > bk["capacity"] and int(pb.overflow) > 0
    sb = pbin.bin_gaussians(ppre, Hb, Wb, capacity=bk["capacity"], max_rect=bk["max_rect"],
                            big_capacity=4096, packed=False)
    assert int(sb.big_overflow) == 0
    assert torch.equal(pb.gather_idx, sb.gather_idx) and torch.equal(pb.counts, sb.counts)


def test_main_axis_allmap_flips_toward_the_camera():
    args, _ = _inputs(np.float64)
    xyz, quat = tt(args[0]), tt(args[2])
    jc, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W)
    am = main_axis_allmap(xyz, quat, pc)
    assert_close(am, np.asarray(j_main_axis_allmap(jnp.asarray(args[0]), jnp.asarray(args[2]), jc)),
                 F64_TOL, "allmap")
    assert bool((am[:, 3] == 1).all())
    world = am[:, :3] @ pc.world_to_cam[:3, :3]  # back to world space
    assert bool(((world * (pc.cam_center - xyz)).sum(-1) >= 0).all())
