"""Parity of the port's training driver with ``curve_gaussian_tpu``'s: the
event and chunk plans, the adaptive capacity rule, a training step with the
learned exposure, extraction and the metrics, and the slice as a whole,
``train_scene`` of both packages on one tiny synthetic scene.

The whole-slice comparison runs in float32 on both sides (the JAX driver
builds its state in float32) with a compressed schedule that fires
densify, the densify_until prune, prune and trim, split and merge.  The
JAX side renders with ``backend="reference"`` (no interpret-mode kernel
to compile); the port with its default route, the plain versions of K1,
K2 and K3 on the CPU, which is the path the card runs with the kernels in
their place (the port's own oracle takes ~3 s a step here, its plain
kernels 0.1 s; both equal the reference within 1e-9 in float64,
``test_torch_port_{blend,render}.py``).  ``tile_capacity=128`` with the default
``big_capacity=256`` keeps both at their floors, so the port's immediate
capacity shrink (the JAX driver shrinks only on a TPU, once the compile is
warm) cannot fire and both run the same shapes.  Compared: the curve count
after every surgery event (exactly), the view of every step, and the
logged losses (1e-4 relative: float32 steps of two libraries drift apart by
rounding).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curve_gaussian_tpu.config import ModelConfig as JModel
from curve_gaussian_tpu.config import OptimizationConfig as JOpt
from curve_gaussian_tpu.config import PipelineConfig as JPipe
from curve_gaussian_tpu.data import synthetic as jsyn
from curve_gaussian_tpu.engine import loop as jloop
from curve_gaussian_tpu.engine import train as jtrain
from curve_gaussian_tpu.eval import extract as jext
from curve_gaussian_tpu.eval import metrics as jmet
from curve_gaussian_tpu.models import surgery as jsurg

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import checkpoint as pck
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.eval import extract as pext
from curve_gaussian_tpu_torch.eval import metrics as pmet
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.models import surgery as psurg
from test_torch_port_geometry import (assert_close, cam_pair, exact_sort, jax_state, jax_x64,
                                      state_arrays, tt)
from test_torch_port_step import _numpy_ts
from test_torch_port_surgery import _seeded_curves, clear_of

TINY = dict(iterations=16, densify_from_iter=1, densify_until_iter=8, densification_interval=4,
            conn_from_iter=8, prune_trim_interval=8, split_interval=8, split_from_iter=4,
            merge_interval=8, position_lr_max_steps=48)
PLANS = [  # (opt fields, first_iter, test, save, checkpoint, scan_chunk)
    ({}, 0, (3000, 10000), (3000, 10000), (), 100),
    (dict(iterations=600, densify_from_iter=30, densify_until_iter=420, conn_from_iter=420,
          densification_interval=120, prune_trim_interval=60, split_interval=60,
          split_from_iter=180, merge_interval=60), 0, (300, 600), (600,), (550,), 100),
    (dict(iterations=600, densify_from_iter=30, densify_until_iter=420, conn_from_iter=420,
          densification_interval=120, prune_trim_interval=60, split_interval=60,
          split_from_iter=180, merge_interval=60), 550, (300, 600), (600,), (550,), 100),
    (TINY, 0, (16,), (16,), (16,), 4),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_event_and_chunk_plans_match_jax(case):
    fields, first, tests, saves, ckpts, chunk = PLANS[case]
    jopt, popt = JOpt(**fields), OptimizationConfig(**fields)
    jev = jloop.build_events(first, jopt, tests, saves, ckpts)
    pev = ploop.build_events(first, popt, tests, saves, ckpts)
    assert pev == jev
    jplan = jloop.chunk_plan(first, jopt, jev, chunk)
    pplan = ploop.chunk_plan(first, popt, pev, chunk)
    assert [tuple(c) for c in pplan] == [tuple(c) for c in jplan] and len(pplan) >= 2
    for it in (first, first + 1, (first + jopt.iterations) // 2):
        assert ploop.future_combos(pplan, it) == jloop.future_combos(jplan, it)


def test_want_tile_capacity_matches_jax():
    for peak in (0, 1, 40, 63, 64, 65, 200, 447, 448, 449, 900, 5000):
        for cur in (128, 256, 896, 1024, 8192):
            for floor in (128, 256, 512):
                assert (ploop.want_tile_capacity(peak, cur, floor)
                        == jloop.want_tile_capacity(peak, cur, floor)), (peak, cur, floor)


def test_exposure_step_matches_jax():
    """One train_step with the learned exposure of view 1 (float64,
    backend="reference"): the loss, every parameter and Adam moment,
    exposure included, within 1e-6 of each array's max."""
    C, M, H, W, K = 8, 6, 64, 64, 136
    with jax_x64(), exact_sort():
        rng = np.random.default_rng(4)
        params, is_bez, alive = state_arrays(rng, C, M, n_lines=2, n_dead=1)
        params["exposure"] = np.array([[1.1, 0.03], [0.85, -0.02], [1.0, 0.0]])
        gt = rng.uniform(size=(H, W)) ** 3
        jc, pc = cam_pair([0.0, 0.2, -1.8], [0, 0, 0], H, W)
        jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
        s0 = _numpy_ts(jts)
        jts, jm = jtrain.train_step(
            jts, jc, jnp.asarray(gt), jnp.zeros(()), JOpt(),
            JPipe(backend="reference", tile_capacity=K), use_mask=True, n_gaussians=M,
            conn_on=True, view_idx=jnp.asarray(1), use_exposure=True)
        ref = _numpy_ts(jts)
    ts = convert.train_state_from_numpy(
        s0["params"], s0["mu"], s0["nu"], s0["count"], s0["is_bezier"], s0["alive"],
        s0["xyz_grad_accum"], s0["denom"], s0["max_radii"], s0["step"], device="cpu")
    with exact_sort():
        _, _, grads, _, _, _, _ = ptrain.step_grads(
            ts, pc, tt(gt), 0.0, OptimizationConfig(),
            PipelineConfig(backend="reference", tile_capacity=K), use_mask=True,
            n_gaussians=M, conn_on=True, view_idx=1, use_exposure=True)
        ts, pm = ptrain.train_step(
            ts, pc, tt(gt), 0.0, OptimizationConfig(),
            PipelineConfig(backend="reference", tile_capacity=K), use_mask=True,
            n_gaussians=M, conn_on=True, view_idx=1, use_exposure=True)
    assert "exposure" in grads and float(grads["exposure"][1].abs().max()) > 0
    assert float(grads["exposure"][[0, 2]].abs().max()) == 0
    assert abs(float(pm["total"]) - float(jm["total"])) <= 1e-6 * abs(float(jm["total"]))
    for k in ref["params"]:
        assert_close(ts.params[k], ref["params"][k], 1e-6, f"param {k}")
        assert_close(ts.opt.mu[k], ref["mu"][k], 1e-6, f"mu {k}")
        assert_close(ts.opt.nu[k], ref["nu"][k], 1e-6, f"nu {k}")
    assert not np.array_equal(ref["params"]["exposure"][1], params["exposure"][1])


def test_extraction_and_metrics_match_jax():
    f = _seeded_curves()
    jh, ph = jsurg.HostCurves(**f), psurg.HostCurves(**f)
    for flag in (True, False):
        jd = jext.curves_to_edge_dict(jh, merge_endpoints_flag=flag)
        pd = pext.curves_to_edge_dict(ph, merge_endpoints_flag=flag)
        assert pd == jd
    jp, jdir = jext.sample_edge_dict(jd, with_directions=True)
    pp, pdir = pext.sample_edge_dict(pd, with_directions=True)
    assert np.array_equal(pp, jp) and np.array_equal(pdir, jdir) and len(pp) > 100
    cp = f["params"]["curve_points"][0].astype(np.float64)
    assert pext.bezier_length(cp) == jext.bezier_length(cp)

    rng = np.random.default_rng(9)
    eyes = ([0.5, 0.5, -1.5], [1.9, 0.6, 0.4], [0.4, 2.0, 0.6])
    with jax_x64():
        pairs = [cam_pair(e, [0.5, 0.5, 0.5], 48, 64) for e in eyes]
    maps = [rng.uniform(size=(48, 64)) ** 2 for _ in eyes]
    jv = jext.filter_visible_edges(jd, [c[0] for c in pairs], maps, frames_ratio=0.5)
    pv = pext.filter_visible_edges(pd, [c[1] for c in pairs], [tt(m) for m in maps],
                                   frames_ratio=0.5)
    assert pv == jv
    n_in = len(jd["curves_ctl_pts"]) + len(jd["lines_end_pts"])
    assert 0 < len(pv["curves_ctl_pts"]) + len(pv["lines_end_pts"]) < n_in

    # the metrics: predictions against a jittered copy of the curves
    gt = {k: (np.asarray(v) + rng.normal(0, 0.004, np.shape(v))).tolist()
          for k, v in jd.items()}
    gp, gdir = pext.sample_edge_dict(gt, with_directions=True)
    dist = np.concatenate([pmet.nn1(gp, pmet.downsample_voxel_average(
        pp, 256, (0, 0, 0), (1, 1, 1)))[0], pmet.nn1(pp, gp)[0]])
    for t in pmet.DEFAULT_THRESHOLDS:  # no distance at a threshold (float32 rounding ~1e-7)
        assert np.abs(dist - t).min() > 1e-5 * t
    jr = jmet.evaluate_edges(jp, gp, jdir, gdir)
    pr = pmet.evaluate_edges(pp, gp, pdir, gdir)
    assert list(pr) == list(jr)
    for k, v in jr.items():
        assert abs(pr[k] - v) <= 1e-6 * max(abs(v), 1e-3), (k, pr[k], v)
    assert 0 < pr["fscore_0.01"] < 1


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

H = W = 64
N_VIEWS, M_G = 4, 4
# the densify threshold sits in a gap of this scene's per-curve gradient
# maxima at iteration 4 (0.156 below, 0.197 above): 4 of 64 curves split
SLICE_OPT = dict(TINY, densify_grad_threshold=0.17, conn_from_iter=7)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Both packages' train_scene on one scene, with what each did."""
    scene = psyn.make_scene(seed=1, n_curves=3, n_lines=1, n_views=N_VIEWS, height=H, width=W,
                            capacity=256, device="cpu")
    maps = [e.numpy() for e in scene.edge_maps]
    jcams = jsyn.ring_cameras(N_VIEWS, H, W)
    seeds = psyn.grid_seed_points(4)
    out = tmp_path_factory.mktemp("slice")
    # one step per chunk: two compiled step shapes on the JAX side, before
    # and after densify_until (the mask and connectivity switch together)
    kw = dict(test_iterations=(16,), save_iterations=(16,), checkpoint_iterations=(16,),
              quiet=True, seed=3, scan_chunk=1)
    rec = {"jax_views": [], "port_views": [], "jax_counts": [], "port_grads": []}
    scan, apply, papply = jloop.train_steps_scan, jsurg.apply_schedule, psurg.apply_schedule
    step = ploop.train_step

    def scan_rec(*a, n_active=None, view_indices=None, **k):
        rec["jax_views"] += np.asarray(view_indices)[: int(n_active)].tolist()
        return scan(*a, n_active=n_active, view_indices=view_indices, **k)

    def apply_rec(ts, it, opt):
        new = apply(ts, it, opt)
        if new is not ts:
            rec["jax_counts"].append((it, int(jnp.sum(new.alive))))
        return new

    def papply_rec(ts, it, opt, **kw):
        if "densify" in psurg.fired_ops(it, opt):
            h = psurg.extract(ts)
            rec["port_grads"].append((h.grad_accum / h.denom).max(axis=1))
        return papply(ts, it, opt, **kw)

    def step_rec(*a, view_idx=None, **k):
        rec["port_views"].append(view_idx)
        return step(*a, view_idx=view_idx, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "train_steps_scan", scan_rec)
        mp.setattr(jsurg, "apply_schedule", apply_rec)
        mp.setattr(ploop, "train_step", step_rec)
        mp.setattr(psurg, "apply_schedule", papply_rec)
        jres = jloop.train_scene(
            jcams, maps, seeds, JModel(n_gaussians=M_G, train_test_exp=True), JOpt(**SLICE_OPT),
            JPipe(backend="reference", tile_capacity=128), str(out / "jax"),
            test_cameras=jcams[:1], test_edge_maps=maps[:1], **kw)
        pres = ploop.train_scene(
            scene.cameras, maps, seeds, ModelConfig(n_gaussians=M_G, train_test_exp=True),
            OptimizationConfig(**SLICE_OPT), PipelineConfig(tile_capacity=128),
            str(out / "port"), test_cameras=scene.cameras[:1], test_edge_maps=maps[:1],
            device="cpu", **kw)
    return jres, pres, rec


def test_slice_surgery_counts_and_views_match_jax(slice_runs):
    jres, pres, rec = slice_runs
    port = [(e["iter"], e["curves"]) for e in pres.events if e["kind"] == "surgery"]
    assert port == rec["jax_counts"]
    fired = {op for e in pres.events if e["kind"] == "surgery" for op in e["ops"]}
    assert fired == {"densify", "densify_until", "prune_trim", "split", "merge"}
    counts = [c for _, c in port]
    assert counts[0] > 64 and counts[-1] < counts[0], counts  # densify grew, merge shrank
    for g in rec["port_grads"]:  # the densify decisions are clear of the threshold
        clear_of(g, SLICE_OPT["densify_grad_threshold"], "densify gradient")
    assert rec["port_views"] == rec["jax_views"] and len(rec["port_views"]) == 16
    assert int(pres.ts.step) == int(jres.ts.step) == 16
    assert pres.ts.alive.shape[0] == jres.ts.alive.shape[0]
    assert pres.pipe_cfg.tile_capacity == jres.pipe_cfg.tile_capacity


# relative, per logged term.  The smoothness term (~1e-5 of the total) sums
# squared second differences of nearby curve samples, which cancel in
# float32 and amplify the parameters' drift between the two packages (2e-4
# measured after 10 steps); every other term, the total included, 1e-4.
LOSS_TOL = {k: 1e-4 for k in ("total", "edge_l1", "ssim", "opacity_pen", "width", "mask",
                              "curve_conn", "test_l1", "test_psnr")}
LOSS_TOL["curve_smo"] = 1e-3


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_slice_logged_losses_match_jax(slice_runs):
    jres, pres, _ = slice_runs
    jrows, prows = _rows(jres.metrics_path), _rows(pres.metrics_path)
    assert [r["iter"] for r in prows] == [r["iter"] for r in jrows]
    n = 0
    for jr, pr in zip(jrows, prows):
        for k, tol in LOSS_TOL.items():
            if k in jr:
                assert abs(pr[k] - jr[k]) <= tol * abs(jr[k]), (jr["iter"], k, pr[k], jr[k])
                n += 1
        for k in ("overflow", "tile_peak", "big_peak", "big_overflow", "n_visible"):
            if k in jr:
                assert pr[k] == jr[k], (jr["iter"], k)
    assert n >= 8
    expo_j = np.asarray(jres.ts.params["exposure"])
    assert_close(pres.ts.params["exposure"], expo_j, 1e-4, "exposure")
    assert np.abs(expo_j - [1.0, 0.0]).max() > 0  # the exposure trained


def test_slice_writes_the_artifact_set(slice_runs):
    _, pres, _ = slice_runs
    for f in ("metrics.jsonl", "parametric_edges.json", "cameras.json", "input.ply",
              "chkpnt16.npz", "exposure.json", "edge_points.ply",
              "point_cloud/iteration_16/point_cloud.ply",
              "point_cloud/iteration_16/ellipsoids_step16.ply",
              "test_images/iter_000016/v00_render.png"):
        assert os.path.exists(os.path.join(pres.model_path, f)), f
    with open(os.path.join(pres.model_path, "parametric_edges.json")) as fh:
        edges = json.load(fh)
    assert edges == pres.edge_dict
    assert len(edges["curves_ctl_pts"]) + len(edges["lines_end_pts"]) >= 1


def test_resume_below_the_seed_count(tmp_path):
    """A checkpoint whose capacity surgery shrank below the seed count
    resumes (the JAX driver's template pads every seed and fails there)."""
    seeds = np.random.default_rng(2).uniform(0.3, 0.7, size=(300, 3)).astype(np.float32)
    small = ptrain.init_train_state(pcs.init_state(seeds[:100], n_views=2, n_gaussians=4,
                                                   device="cpu"))
    small = dataclasses.replace(small, step=5)
    path = str(tmp_path / "chkpnt5.npz")
    pck.save_checkpoint(path, small)
    cams = psyn.ring_cameras(2, 32, 32, device="cpu")
    maps = [np.zeros((32, 32), np.float32)] * 2
    res = ploop.train_scene(cams, maps, seeds, ModelConfig(n_gaussians=4),
                            OptimizationConfig(iterations=7), PipelineConfig(tile_capacity=128),
                            str(tmp_path / "run"), test_iterations=(), start_checkpoint=path,
                            quiet=True, device="cpu")
    assert (int(res.ts.step), res.ts.alive.shape[0]) == (7, 256)
    assert 0 < int(res.ts.alive.sum()) <= 100  # the last iteration merges


def test_multi_device_arguments_raise():
    """More devices than the process group's ranks (no group: one) raise,
    saying what to launch, rather than training on fewer."""
    with pytest.raises(RuntimeError, match="needs 2 ranks and this process has no process"):
        ploop.train_scene([], [], np.zeros((4, 3)), ModelConfig(), OptimizationConfig(),
                          PipelineConfig(), "unused", device="cpu", n_devices=2)


@pytest.fixture
def one_torch_thread():
    """Tiny tensors: one intra-op thread leaves the cores to the suite's
    other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_adaptive_capacity_shrink(tmp_path, monkeypatch, one_torch_thread):
    """The port's adaptive shrink of K and the big tier, applied at a chunk
    end (the JAX driver shrinks only on a TPU, once the smaller shapes'
    compile is warm, so no parity run covers it): forced by starting both
    far above the observed peaks, both shrinks are logged, the steps after
    them run at the smaller capacities, and the first of them equals one
    step of the state saved at the shrink, taken at those capacities,
    within 1e-6 of each array's max."""
    caps = []

    def recording_step(ts, cam, gt, bg, opt_cfg, pipe_cfg, **kw):
        caps.append((int(ts.step), pipe_cfg.tile_capacity, pipe_cfg.big_capacity))
        return ptrain.train_step(ts, cam, gt, bg, opt_cfg, pipe_cfg, **kw)

    monkeypatch.setattr(ploop, "train_step", recording_step)
    scene = psyn.make_scene(seed=1, n_curves=3, n_lines=1, n_views=1, height=64, width=64,
                            capacity=128, device="cpu")
    seeds = psyn.grid_seed_points(4)
    opt = OptimizationConfig(iterations=4)
    res = ploop.train_scene(scene.cameras, scene.edge_maps, seeds, ModelConfig(n_gaussians=6),
                            opt, PipelineConfig(tile_capacity=1024, big_capacity=1024),
                            str(tmp_path), test_iterations=(), checkpoint_iterations=(2, 3),
                            scan_chunk=2, quiet=True, dump_images=False, device="cpu")
    shrinks = {e["kind"]: (e["iter"], e["old"], e["new"]) for e in res.events
               if e.get("why") == "shrink"}
    small = res.pipe_cfg
    assert shrinks == {"tile_capacity": (2, 1024, small.tile_capacity),
                       "big_capacity": (2, 1024, small.big_capacity)}
    assert small.tile_capacity <= 512 and small.big_capacity <= 512
    assert caps == [(0, 1024, 1024), (1, 1024, 1024)] + [
        (i, small.tile_capacity, small.big_capacity) for i in (2, 3)]

    def load(it):
        path = str(tmp_path / f"chkpnt{it}.npz")
        cap, _ = pck.checkpoint_capacity(path)
        return pck.load_checkpoint(path, ptrain.init_train_state(pcs.init_state(
            seeds, n_views=1, n_gaussians=6, capacity=cap, device="cpu")))

    plan = ploop.chunk_plan(0, opt, ploop.build_events(0, opt, (), (), (2, 3)), 2)
    (chunk,) = [c for c in plan if c.start == 2]
    ts, _ = ptrain.train_step(load(2), scene.cameras[0], scene.edge_maps[0], 0.0, opt, small,
                              use_mask=chunk.use_mask, n_gaussians=6, conn_on=chunk.conn_on)
    want = pck.named_leaves(load(3))
    got = pck.named_leaves(ts)
    assert got.keys() == want.keys()
    for k, w in want.items():
        a, b = pck.leaf_array(got[k]).astype(np.float64), pck.leaf_array(w).astype(np.float64)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30), k
