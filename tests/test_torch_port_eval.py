"""Parity of the port's evaluation and export slice with the JAX package:
SH, batched SSIM, the Bézier, covariance, state, loss and PLY helpers, the
ABC harness, the Replica overlays, and the three scripts (render_curves,
run_batch_abc, eval_gt_json).  Inputs are made by numpy from a seed; each
test states its tolerance.

The metrics compare within 1e-12 with the JAX package's nearest-neighbour
search on its scipy ``cKDTree`` route (its C++ library turned off for the
test), the route the port's ``eval/metrics.py`` mirrors: the library
rounds distances to float32, ~1e-7 apart.  PIL reads the JAX package's
PNGs here; the port never imports it.
"""
import hashlib
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from curve_gaussian_tpu import native as jnative
from curve_gaussian_tpu.data import synthetic as jsyn
from curve_gaussian_tpu.eval import abc as jabc
from curve_gaussian_tpu.eval import replica as jrep
from curve_gaussian_tpu.models import curve_state as jcs
from curve_gaussian_tpu.models import gaussian_ply as jply
from curve_gaussian_tpu.models import losses as jloss
from curve_gaussian_tpu.ops import bezier as jbez
from curve_gaussian_tpu.ops import projection as jproj
from curve_gaussian_tpu.ops import render as jrender
from curve_gaussian_tpu.ops import sh as jsh
from curve_gaussian_tpu.ops import ssim as jssim

from curve_gaussian_tpu_torch import train as ptrain
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.data.png import read_png
from curve_gaussian_tpu_torch.eval import abc as pabc
from curve_gaussian_tpu_torch.eval import replica as prep
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.models import gaussian_ply as pply
from curve_gaussian_tpu_torch.models import losses as ploss
from curve_gaussian_tpu_torch.ops import bezier as pbez
from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import sh as psh
from curve_gaussian_tpu_torch.ops import ssim as pssim
from curve_gaussian_tpu_torch.ops import ssim_cuda as psc
from curve_gaussian_tpu_torch.scripts import eval_gt_json as peval_gt
from curve_gaussian_tpu_torch.scripts import render_curves as prc
from curve_gaussian_tpu_torch.scripts import run_batch_abc as pbatch
from test_torch_port_geometry import (assert_close, cam_pair, jax_state, jax_x64, rel_err,
                                      state_arrays, tt)

ROOT = Path(__file__).resolve().parent.parent


def _np(t):
    return t.detach().numpy()


@pytest.fixture
def scipy_nn(monkeypatch):
    """The JAX package's metrics on its scipy route (see the docstring)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


# -- SH ------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    """float64 on both sides, within 1e-12 of max."""
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(7, 3, (deg + 1) ** 2))
    dirs = rng.normal(size=(7, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    with jax_x64():
        ref = jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
        rgb = rng.uniform(size=(5, 3))
        ref_sh, ref_rgb = jsh.rgb_to_sh(jnp.asarray(rgb)), jsh.sh_to_rgb(jnp.asarray(sh))
    assert_close(psh.eval_sh(deg, tt(sh), tt(dirs)), np.asarray(ref), 1e-12, "eval_sh")
    assert_close(psh.rgb_to_sh(tt(rgb)), np.asarray(ref_sh), 1e-12, "rgb_to_sh")
    assert_close(psh.sh_to_rgb(tt(sh)), np.asarray(ref_rgb), 1e-12, "sh_to_rgb")
    assert (psh.C0, psh.C1, psh.C2, psh.C3) == (jsh.C0, jsh.C1, jsh.C2, jsh.C3)


# -- SSIM ------------------------------------------------------------------------


def _ssim_pair(shape, dtype, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(dtype)
    b = (0.5 * a + 0.5 * rng.uniform(size=shape) ** 3).astype(dtype)
    return a, b


def _port_ssim(a, b, method=None):
    at = tt(a, None).requires_grad_(True)
    bt = tt(b, None).requires_grad_(True)
    v = pssim.ssim(at, bt, method=method)
    v.backward()
    return v.detach(), at.grad, bt.grad


@pytest.mark.parametrize("dtype,vtol,gtol", [(np.float32, 1e-6, 1e-5),
                                             (np.float64, 1e-12, 1e-10)])
def test_batched_ssim_matches_jax_matmul(dtype, vtol, gtol):
    """A [3, 40, 56] stack against JAX ``ssim(method="matmul")``: the value
    within `vtol`, each gradient within `gtol` of its max."""
    a, b = _ssim_pair((3, 40, 56), dtype)
    with jax_x64():
        jv, (ja, jb) = jax.value_and_grad(
            lambda x, y: jssim.ssim(x, y, method="matmul"), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    v, ga, gb = _port_ssim(a, b)
    assert v.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    assert abs(float(v) - float(jv)) <= vtol
    assert_close(ga, np.asarray(ja), gtol, "d img1")
    assert_close(gb, np.asarray(jb), gtol, "d img2")


def test_ssim_routes():
    """A 2-D float32 pair takes the fused route (K7/K8's plain versions
    here), which agrees with the matmul route within 1e-6 in value and
    gradients (of max); "fused" on a batch or a float64 pair and an unknown
    method raise in both packages."""
    a, b = _ssim_pair((40, 56), np.float32, 5)
    n7, n8 = psc.ssim_fwd.launches, psc.ssim_bwd.launches
    fused = _port_ssim(a, b)
    mm = _port_ssim(a, b, method="matmul")
    assert abs(float(fused[0]) - float(mm[0])) <= 1e-6
    for f, m in zip(fused[1:], mm[1:]):
        assert rel_err(f, m.numpy()) <= 1e-6
    assert float(pssim.ssim(tt(a, None), tt(b, None), method="fused")) == float(fused[0])
    assert (psc.ssim_fwd.launches, psc.ssim_bwd.launches) == (n7, n8)
    batch, pair64 = _ssim_pair((2, 20, 24), np.float32), _ssim_pair((20, 24), np.float64)
    for x, y in (batch, pair64):
        with pytest.raises(ValueError, match="2-D float32"):
            pssim.ssim(tt(x, None), tt(y, None), method="fused")
        with jax_x64(), pytest.raises(ValueError, match="2-D float32"):
            jssim.ssim(jnp.asarray(x), jnp.asarray(y), method="fused")
    with pytest.raises(ValueError, match="method"):
        pssim.ssim(tt(a, None), tt(b, None), method="conv")
    with pytest.raises(ValueError, match="method"):
        jssim.ssim(jnp.asarray(a), jnp.asarray(b), method="conv")


# -- geometry, state, loss helpers --------------------------------------------------


def test_bezier_helpers_match_jax():
    """Evaluation, tangents, De Casteljau split and trim and lengths, float64,
    within 1e-12 of max."""
    rng = np.random.default_rng(11)
    cp = rng.uniform(-1, 1, size=(6, 4, 3))
    is_bez = np.array([True, False, True, True, False, True])
    t = rng.uniform(size=9)
    ts, t0, t1 = rng.uniform(size=6), rng.uniform(-0.1, 0.5, 6), rng.uniform(0.5, 1.1, 6)
    with jax_x64():
        J = {k: np.asarray(v) for k, v in {
            "bezier_point": jbez.bezier_point(jnp.asarray(cp), jnp.asarray(t)),
            "bezier_tangent": jbez.bezier_tangent(jnp.asarray(cp), jnp.asarray(t)),
            "line_point": jbez.line_point(jnp.asarray(cp), jnp.asarray(t)),
            "line_tangent": jbez.line_tangent(jnp.asarray(cp), jnp.asarray(t)),
            "curve_point": jbez.curve_point(jnp.asarray(cp), jnp.asarray(t),
                                            jnp.asarray(is_bez)),
            "curve_tangent": jbez.curve_tangent(jnp.asarray(cp), jnp.asarray(t),
                                                jnp.asarray(is_bez)),
            "split_l": jbez.de_casteljau_split(jnp.asarray(cp), jnp.asarray(ts),
                                               jnp.asarray(is_bez))[0],
            "split_r": jbez.de_casteljau_split(jnp.asarray(cp), jnp.asarray(ts),
                                               jnp.asarray(is_bez))[1],
            "trim": jbez.de_casteljau_trim(jnp.asarray(cp), jnp.asarray(t0), jnp.asarray(t1),
                                           jnp.asarray(is_bez)),
            "lengths": jbez.curve_lengths(jnp.asarray(cp), jnp.asarray(is_bez)),
        }.items()}
    c, tq, bz = tt(cp), tt(t), torch.as_tensor(is_bez)
    P = {
        "bezier_point": pbez.bezier_point(c, tq),
        "bezier_tangent": pbez.bezier_tangent(c, tq),
        "line_point": pbez.line_point(c, tq),
        "line_tangent": pbez.line_tangent(c, tq),
        "curve_point": pbez.curve_point(c, tq, bz),
        "curve_tangent": pbez.curve_tangent(c, tq, bz),
        "split_l": pbez.de_casteljau_split(c, tt(ts), bz)[0],
        "split_r": pbez.de_casteljau_split(c, tt(ts), bz)[1],
        "trim": pbez.de_casteljau_trim(c, tt(t0), tt(t1), bz),
        "lengths": pbez.curve_lengths(c, bz),
    }
    for k in J:
        assert_close(P[k], J[k], 1e-12, k)


def test_covariance_helpers_match_jax():
    """``build_cov3d`` and ``ewa_cov2d``, float64, within 1e-10 of max."""
    rng = np.random.default_rng(12)
    P = 40
    xyz = rng.uniform(-0.3, 0.3, size=(P, 3))
    scale = rng.uniform(0.002, 0.05, size=(P, 3))
    quat = rng.normal(size=(P, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    with jax_x64():
        jc, pc = cam_pair([0.3, 0.2, -2.0], [0.0, 0.0, 0.0], 48, 64)
        jcov = jproj.build_cov3d(jnp.asarray(scale), jnp.asarray(quat), 1.3)
        j2d = jproj.ewa_cov2d(jnp.asarray(xyz), jcov, jc)
    pcov = pproj.build_cov3d(tt(scale), tt(quat), 1.3)
    assert_close(pcov, np.asarray(jcov), 1e-10, "cov3d")
    assert_close(pproj.ewa_cov2d(tt(xyz), pcov, pc), np.asarray(j2d), 1e-10, "cov2d")


def test_state_and_loss_helpers_match_jax():
    """``with_trainable``, ``mask_sigmoid``, ``inverse_sigmoid``, ``l1_loss``
    and ``psnr``, float64, within 1e-12 (of max)."""
    rng = np.random.default_rng(13)
    params, is_bez, alive = state_arrays(rng, 6, 4)
    new = {"width_raw": rng.normal(size=6), "mask_raw": rng.normal(size=(6, 4))}
    x = rng.uniform(0.05, 0.95, size=10)
    a, b = rng.uniform(size=(24, 20)), rng.uniform(size=(24, 20))
    with jax_x64():
        js = jcs.with_trainable(jax_state(params, is_bez, alive),
                                {k: jnp.asarray(v) for k, v in new.items()})
        jm = jcs.mask_sigmoid(js)
        jinv = jcs.inverse_sigmoid(jnp.asarray(x))
        jl1, jpsnr = jloss.l1_loss(jnp.asarray(a), jnp.asarray(b)), jloss.psnr(
            jnp.asarray(a), jnp.asarray(b))
    ps = pcs.CurveState(**{k: tt(v) for k, v in params.items()},
                        is_bezier=torch.as_tensor(is_bez), alive=torch.as_tensor(alive))
    ps = pcs.with_trainable(ps, {k: tt(v) for k, v in new.items()})
    for k in pcs.TRAINABLE_FIELDS:
        assert np.array_equal(_np(getattr(ps, k)), np.asarray(getattr(js, k))), k
    assert ps.capacity == js.capacity and torch.equal(ps.alive, torch.as_tensor(alive))
    assert_close(pcs.mask_sigmoid(ps), np.asarray(jm), 1e-12, "mask_sigmoid")
    assert_close(pcs.inverse_sigmoid(tt(x)), np.asarray(jinv), 1e-12, "inverse_sigmoid")
    assert abs(float(ploss.l1_loss(tt(a), tt(b))) - float(jl1)) <= 1e-12
    assert abs(float(ploss.psnr(tt(a), tt(b))) - float(jpsnr)) <= 1e-12 * float(jpsnr)


def test_gaussian_ply_interop(tmp_path):
    """A file the JAX writer makes loads in the port to equal arrays, and the
    other way round (bitwise: both read float32 columns)."""
    rng = np.random.default_rng(14)
    P = 30
    xyz = rng.normal(size=(P, 3)).astype(np.float32)
    opa = rng.uniform(0.05, 0.95, size=P).astype(np.float32)
    scale = rng.uniform(1e-3, 1e-1, size=(P, 3)).astype(np.float32)
    quat = rng.normal(size=(P, 4)).astype(np.float32)
    dc = rng.normal(size=(P, 3)).astype(np.float32)
    for save, load, name in ((jply.save_gaussian_ply, pply.load_gaussian_ply, "j.ply"),
                             (pply.save_gaussian_ply, jply.load_gaussian_ply, "p.ply")):
        path = str(tmp_path / name)
        save(path, xyz, opa, scale, quat, dc)
        got, ref = load(path), jply.load_gaussian_ply(path)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
        np.testing.assert_allclose(got["scale"], scale, rtol=1e-5)
    with open(tmp_path / "j.ply", "rb") as f, open(tmp_path / "p.ply", "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("edit", [
    (b"binary_little_endian", b"ascii"),
    (b"property float opacity", b"property double opacity"),
    (b"end_header\n", b"element face 0\nend_header\n"),
    (b"element vertex 4", b"element vertex 5"),
])
def test_load_gaussian_ply_rejects_other_layouts(tmp_path, edit):
    """A PLY whose format, elements, property types or length differ from
    the 3DGS layout raises instead of being misread."""
    rng = np.random.default_rng(15)
    path = str(tmp_path / "g.ply")
    pply.save_gaussian_ply(path, rng.normal(size=(4, 3)), np.full(4, 0.5),
                           np.full((4, 3), 0.01), rng.normal(size=(4, 4)))
    pply.load_gaussian_ply(path)
    with open(path, "rb") as f:
        data = f.read()
    assert edit[0] in data
    with open(path, "wb") as f:
        f.write(data.replace(edit[0], edit[1], 1))
    with pytest.raises(ValueError):
        pply.load_gaussian_ply(path)


# -- the ABC harness ------------------------------------------------------------------


def write_abc_gt(base: Path, scans) -> str:
    """An ABC-style GT directory: per scan, an L-shaped pair of sharp edges
    (a Line and a BSpline) and a non-sharp Line (as in tests/test_eval_abc.py)."""
    objdir = base / "obj"
    objdir.mkdir(parents=True)
    verts = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [5, 5, 5]], float)
    feats, stats = {}, {}
    for scan in scans:
        with open(objdir / f"{scan}_whatever.obj", "w") as f:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        feats[scan] = [
            {"type": "Line", "sharp": True, "vert_indices": [0, 1]},
            {"type": "BSpline", "sharp": True, "vert_indices": [1, 2]},
            {"type": "Line", "sharp": False, "vert_indices": [2, 3]},
        ]
        stats[scan] = {"bbox": [0, 0, 0, 10, 10, 10, 10, 10, 10]}
    with open(base / "chunk_0000_feats.json", "w") as f:
        json.dump(feats, f)
    with open(base / "chunk_0000_stats.json", "w") as f:
        json.dump(stats, f)
    return str(base)


@pytest.fixture
def abc_gt_dir(tmp_path):
    return write_abc_gt(tmp_path / "abc", ["00000042"]), "00000042"


def _prediction(path, seed=15):
    """A jittered L plus a stray Bézier, as parametric_edges.json."""
    rng = np.random.default_rng(seed)
    edges = {
        "lines_end_pts": (np.array([[0, 0, 0, 1, 0, 0], [1, 0, 0, 1, 1, 0]], float)
                          + rng.normal(0, 0.004, (2, 6))).tolist(),
        "curves_ctl_pts": [[0.2, 0.5, 0.1, 0.3, 0.6, 0.1, 0.5, 0.6, 0.2, 0.6, 0.5, 0.2]],
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(edges, f)
    return edges


def test_abc_gt_points_equal_jax(abc_gt_dir):
    """``get_gt_points`` equals JAX bitwise for every edge type, and pins the
    reference's reversed chain sampling (t = 0 on the next vertex)."""
    base, scan = abc_gt_dir
    for et in ("all", "line", "curve"):
        got, ref = pabc.get_gt_points(scan, base, edge_type=et), jabc.get_gt_points(
            scan, base, edge_type=et)
        for g, r in zip(got, ref, strict=True):
            assert g.dtype == r.dtype == np.float32 and np.array_equal(g, r), et
    pts, _ = pabc.get_gt_points(scan, base, interval=0.1)
    assert np.array_equal(pts[0], np.array([1.0, 0.0, 0.0], np.float32))  # vertex 1 first
    assert pabc.load_obj_vertices(str(Path(base) / "obj" / f"{scan}_whatever.obj")).shape == (
        4, 3)


def test_abc_evaluate_scan_and_batch_equal_jax(abc_gt_dir, tmp_path, scipy_nn, monkeypatch):
    """``evaluate_scan`` and ``evaluate_batch`` equal JAX's dicts within 1e-12
    (a missing scan skipped by both); the port's scatter diagnostic decodes
    to its [3*256+4, 2*256+3, 3] raster with GT and prediction pixels (the
    JAX package's matplotlib figure is not drawn: no number depends on it)."""
    monkeypatch.setattr(jabc, "scatter_diagnostic", lambda *a, **kw: None)
    base, scan = abc_gt_dir
    out = tmp_path / "out"
    pred = str(out / scan / "parametric_edges.json")
    _prediction(pred)
    got, ref = pabc.evaluate_scan(pred, scan, base), jabc.evaluate_scan(pred, scan, base)
    assert sorted(got) == sorted(ref) and {"acc_line", "comp_curve"} <= set(got)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-12, (k, got[k], v)
    assert 0 < got["fscore_0.01"] < 1
    plog, jlog = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    pagg = pabc.evaluate_batch(str(out), [scan, "00000099"], base, log_path=plog)
    img = read_png(str(out / scan / "pred_vs_gt.png"))
    jagg = jabc.evaluate_batch(str(out), [scan, "00000099"], base, log_path=jlog)
    assert sorted(pagg) == sorted(jagg)
    assert all(abs(pagg[k] - v) <= 1e-12 for k, v in jagg.items())
    with open(plog) as f, open(jlog) as g:
        pl, jl = json.load(f), json.load(g)
    assert list(pl["per_scan"]) == list(jl["per_scan"]) == [scan]
    assert img.shape == (3 * 256 + 4, 2 * 256 + 3, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert {pabc.GT_RGB, pabc.PRED_RGB} <= colours


# -- Replica overlays ------------------------------------------------------------------


def _edges_json(path, seed=16):
    rng = np.random.default_rng(seed)
    centre = np.array([0.5, 0.5, 0.5])
    edges = {
        "curves_ctl_pts": (centre + rng.uniform(-0.3, 0.3, (3, 4, 3))).reshape(3, 12).tolist(),
        "lines_end_pts": (centre + rng.uniform(-0.3, 0.3, (2, 2, 3))).reshape(2, 6).tolist(),
    }
    with open(path, "w") as f:
        json.dump(edges, f)
    return edges


def test_replica_overlays_equal_jax(tmp_path):
    """``project_points`` equals JAX's bitwise on ring cameras, the port's
    overlay frames decode to the JAX frames (read with PIL), and the stats
    agree."""
    pred = str(tmp_path / "edges.json")
    edges = _edges_json(pred)
    H, W, n = 36, 44, 3
    jcams = jsyn.ring_cameras(n, H, W)
    pcams = psyn.ring_cameras(n, H, W, device="cpu")
    maps = [np.random.default_rng(20 + i).uniform(size=(H, W)).astype(np.float32) ** 3
            for i in range(n)]
    pts, _ = pabc.sample_edge_dict(edges)
    for jc, pc in zip(jcams, pcams):
        for g, r in zip(prep.project_points(pc, pts), jrep.project_points(jc, pts)):
            assert np.array_equal(g, r)
    pstats = prep.evaluate_replica(pred, pcams, [torch.as_tensor(m) for m in maps],
                                   str(tmp_path / "p"))
    jstats = jrep.evaluate_replica(pred, jcams, maps, str(tmp_path / "j"))
    assert pstats == jstats == {"n_curves": 3, "n_lines": 2, "n_frames": n}
    with open(tmp_path / "p" / "stats.json") as f:
        assert json.load(f) == pstats
    for i in range(n):
        g = read_png(str(tmp_path / "p" / f"frame_{i:04d}.png"))
        r = np.asarray(Image.open(tmp_path / "j" / f"frame_{i:04d}.png"))
        assert g.shape == (H, 2 * W, 3) and np.array_equal(g, r), i
        assert (g == [255, 25, 25]).all(-1).any()  # projected edge pixels
    assert prep.stitch_video(str(tmp_path / "p"), str(tmp_path / "v.mp4")) == (
        shutil.which("ffmpeg") is not None)


# -- render_curves -----------------------------------------------------------------------


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_render_curves_matches_jax(tmp_path, monkeypatch):
    """The JAX script's own main() with its render on the JAX oracle
    (``backend="reference"``) against the port's ``render_curves`` (K3's
    plain version here), 3 frames of 48²: frame 0's render within 1e-5, and
    every PNG equal to the JAX script's (PIL) except where the oracle's value
    lies within 1e-5 of a uint8 level boundary (then within one level).  On
    a transforms file both make the same cameras (bitwise)."""
    edges = str(tmp_path / "edges.json")
    _edges_json(edges)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo root
    script = _jax_script("render_curves")
    calls, real_render = [], jrender.render
    ref = jax.jit(lambda *a: real_render(*a, bg=0.0, capacity=1024, backend="reference")[
        "render"])  # one compile for every frame (the camera's sizes are static)

    def oracle(*a, **kw):  # records (camera, render); renders only the orbit's frames
        assert kw == {"bg": 0.0, "capacity": 1024}
        img = ref(*a) if len(calls) < 3 else jnp.zeros((a[4].height, a[4].width))
        calls.append((a[4], np.asarray(img)))
        return {"render": img}

    monkeypatch.setattr(jrender, "render", oracle)
    args = ["--edges", edges, "--size", "48", "--n-orbit", "3"]
    monkeypatch.setattr(sys, "argv", ["render_curves.py", "--out", str(tmp_path / "j")] + args)
    script.main()
    res = prc.render_curves(args + ["--out", str(tmp_path / "p"), "--device", "cpu"],
                            quiet=True)
    assert len(calls) == len(res["sha256"]) == 3 and not res["video"]
    assert np.abs(res["first_frame"] - calls[0][1]).max() <= 1e-5
    for i, (_, ref) in enumerate(calls):
        g = read_png(os.path.join(res["frame_dir"], f"frame_{i:04d}.png"))
        r = np.asarray(Image.open(tmp_path / "j" / "frames" / f"frame_{i:04d}.png"))
        assert hashlib.sha256(g.tobytes()).hexdigest() == res["sha256"][i]
        x = np.clip(ref, 0, 1) * 255
        near = np.abs(x - np.round(x)) <= 255e-5
        diff = g.astype(int) - r.astype(int)
        assert np.abs(diff).max() <= 1 and not diff[~near].any() and (r > 0).sum() > 50

    fr = []
    for eye in ([0.5, 0.5, 2.6], [0.6, 0.4, 2.4]):  # OpenGL c2w looking down -z at the cube
        c2w = np.eye(4)
        c2w[:3, 3] = eye
        fr.append({"transform_matrix": c2w.tolist()})
    tv = str(tmp_path / "transforms_video.json")
    with open(tv, "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": fr}, f)
    del calls[3:]
    monkeypatch.setattr(sys, "argv", ["render_curves.py", "--out", str(tmp_path / "jt"),
                                      "--transforms", tv] + args)
    script.main()
    pcams = prc.video_cameras(prc.parse_args(args + ["--transforms", tv]), "cpu")
    assert len(pcams) == len(calls) - 3 == 2
    for pc, (jc, _) in zip(pcams, calls[3:]):
        for k in ("world_to_cam", "full_proj", "cam_center"):
            assert np.array_equal(_np(getattr(pc, k)), np.asarray(getattr(jc, k))), k
        assert (pc.tanfovx, pc.tanfovy, pc.height, pc.width) == (
            jc.tanfovx, jc.tanfovy, jc.height, jc.width)
    with pytest.raises(NotImplementedError, match="slice 11"):
        prc.render_curves(args + ["--device", "cpu", "--n-devices", "2"])


# -- the batch driver and eval_gt_json -----------------------------------------------------


def test_batch_driver_skip_failure_and_eval(tmp_path, monkeypatch, scipy_nn):
    """In process: a done scan is skipped, a failing scan is recorded and the
    next one still trains (the port's ``train.main`` stubbed); the GT
    evaluation writes eval_summary.json with finite numbers.  By subprocess:
    each command runs ``-m curve_gaussian_tpu_torch.train`` with the device,
    and a non-zero exit is a failure."""
    scans = ("00000041", "00000042", "00000043")
    base = write_abc_gt(tmp_path / "abc", scans)
    data, out = tmp_path / "data", tmp_path / "out"
    for s in scans:
        (data / s).mkdir(parents=True)
    _prediction(str(out / "00000041" / "parametric_edges.json"))
    calls = []

    def fake_main(argv):
        scan = os.path.basename(argv[argv.index("-s") + 1])
        calls.append((scan, argv[argv.index("--device") + 1], argv[-2:]))
        if scan == "00000042":
            raise RuntimeError("boom")
        _prediction(os.path.join(argv[argv.index("-m") + 1], "parametric_edges.json"))

    monkeypatch.setattr(ptrain, "main", fake_main)
    common = ["--data-root", str(data), "--output-root", str(out), "--device", "cpu"]
    res = pbatch.main(common + ["--in-process", "--gt-base-dir", base,
                                "--extra", "--iterations", "7"])
    assert res == (["00000043"], ["00000041"], ["00000042"])
    assert calls == [(s, "cpu", ["--iterations", "7"]) for s in ("00000042", "00000043")]
    with open(out / "eval_summary.json") as f:
        summary = json.load(f)
    assert list(summary["per_scan"]) == ["00000041", "00000043"]  # the failed scan has none
    assert summary["mean"] and all(np.isfinite(v) for v in summary["mean"].values())
    assert {"acc_line", "comp_curve", "chamfer"} <= set(summary["mean"])

    cmds = []
    monkeypatch.setattr(pbatch.subprocess, "call", lambda cmd: cmds.append(cmd) or 3)
    assert pbatch.main(common) == ([], ["00000041", "00000043"], ["00000042"])
    assert cmds == [[sys.executable, "-m", "curve_gaussian_tpu_torch.train", "-s",
                     str(data / "00000042"), "-m", str(out / "00000042"), "-r", "2",
                     "--detector", "DexiNed", "--device", "cpu"]]


def test_eval_gt_json_matches_the_jax_script(tmp_path, monkeypatch, scipy_nn):
    """The port's script writes the JAX script's numbers (within 1e-12)."""
    pred, gt = str(tmp_path / "pred.json"), str(tmp_path / "gt.json")
    edges = _edges_json(gt)
    jit = {k: (np.asarray(v) + np.random.default_rng(17).normal(0, 0.003, np.shape(v))).tolist()
           for k, v in edges.items()}
    with open(pred, "w") as f:
        json.dump(jit, f)
    monkeypatch.setattr(sys, "path", list(sys.path))
    script = _jax_script("eval_gt_json")
    monkeypatch.setattr(jax.config, "update", lambda k, v: None)
    monkeypatch.setattr(sys, "argv", ["eval_gt_json.py", "--pred", pred, "--gt", gt, "--out",
                                      str(tmp_path / "j.json")])
    script.main()
    got = peval_gt.eval_gt_json(["--pred", pred, "--gt", gt, "--out", str(tmp_path / "p.json")])
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == got
    assert list(got) == list(ref) and 0 < got["fscore_0.01"] <= 1
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-12, (k, got[k], v)
