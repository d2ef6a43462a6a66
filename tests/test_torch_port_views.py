"""Parity of the port's view-batched training step
(``curve_gaussian_tpu_torch/parallel/sharding.py``) with the JAX package's
``parallel/sharding.py`` at one device, ``mesh_shape=(("data", 1),)``:
one B-view step, a chunk of K steps of B views, the chunk's eager body
against K single steps, the B = 1 step against ``train_step``, and both
packages' ``train_scene`` at ``views_per_step=2``.

(a)-(b) run in float64 (``jax_x64``, ``exact_sort``) with the JAX side on
``backend="reference"`` and the port on its default route (the plain
versions of K1, K2, K7 and K8 on the CPU, the path the card runs with the
kernels in their place): each array within 1e-6 of its max (``F64_TOL``
of ``test_torch_port_step.py``).  (c)-(d) hold the port against itself,
bitwise.  (e) compares the drivers in float32, as
``test_torch_port_loop.py`` does: the [k, B] view tables and the curve
counts after each surgery exactly, the logged ``total`` within its
``LOSS_TOL``.  ``tests/conftest.py`` gives JAX 8 virtual devices, so the
JAX driver is given ``n_devices=1``: left to itself it would take a
2-device mesh for B = 2.
"""
import dataclasses
import json

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
from curve_gaussian_tpu.models import surgery as jsurg
from curve_gaussian_tpu.parallel import sharding as jps

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.ops import camera as pcam
from curve_gaussian_tpu_torch.parallel import sharding as pps
from test_torch_port_geometry import (assert_close, cam_pair, exact_sort, jax_state, jax_x64,
                                      state_arrays, tt)
from test_torch_port_loop import LOSS_TOL
from test_torch_port_step import F64_TOL, _numpy_ts

C, M, H, W = 8, 6, 32, 64
TILE_K = 136
EYES = ([0.0, 0.2, -1.8], [0.3, -0.1, -1.7], [-0.4, 0.1, -1.75], [0.1, 0.45, -1.6])
EXPOSURE = [[1.1, 0.03], [0.85, -0.02], [1.0, 0.0], [0.95, 0.01]]
MESH1 = (("data", 1),)
METRICS = ("total", "overflow", "n_visible", "tile_peak", "big_overflow")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread leaves the cores to the suite's
    other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _problem(seed=0):
    """numpy leaves of a state with one exposure row per view, the views'
    ground truths, and both packages' cameras (float64)."""
    rng = np.random.default_rng(seed)
    params, is_bez, alive = state_arrays(rng, C, M, n_lines=2, n_dead=1)
    params["exposure"] = np.array(EXPOSURE)
    gts = rng.uniform(size=(len(EYES), H, W)) ** 3
    with jax_x64():
        pairs = [cam_pair(e, [0, 0, 0], H, W) for e in EYES]
    return params, is_bez, alive, gts, [p[0] for p in pairs], [p[1] for p in pairs]


def _port_ts(s0, dtype=torch.float64):
    return convert.train_state_from_numpy(
        s0["params"], s0["mu"], s0["nu"], s0["count"], s0["is_bezier"], s0["alive"],
        s0["xyz_grad_accum"], s0["denom"], s0["max_radii"], s0["step"],
        s0["opacity_frozen"], device="cpu", dtype=dtype)


def _geom(cams):
    return (cams[0].height, cams[0].width, cams[0].tanfovx, cams[0].tanfovy)


def _assert_state_matches(ts, ref, tol):
    for k in ref["params"]:
        assert_close(ts.params[k], ref["params"][k], tol, f"param {k}")
        assert_close(ts.opt.mu[k], ref["mu"][k], tol, f"mu {k}")
        assert_close(ts.opt.nu[k], ref["nu"][k], tol, f"nu {k}")
    for k in ("xyz_grad_accum", "denom", "max_radii"):
        assert_close(getattr(ts, k), ref[k], tol, k)
    assert (ts.step, ts.opt.count) == (ref["step"], ref["count"])


def _assert_states_equal(a, b):
    la, lb = ptrain._state_leaves(a), ptrain._state_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
    assert (a.step, a.opt.count, a.opacity_frozen) == (b.step, b.opt.count, b.opacity_frozen)


def _assert_metrics_match(pm, jm):
    assert set(pm) == set(jm) == set(METRICS)
    assert abs(float(pm["total"]) - float(jm["total"])) <= F64_TOL * abs(float(jm["total"]))
    for k in METRICS[1:]:
        assert int(pm[k]) == int(jm[k]), k


# ---------------------------------------------------------------------------
# (a) one step
# ---------------------------------------------------------------------------

STEP_CASES = {  # views, exposure
    "B2": ([0, 1], False),
    "B3-exposure": ([2, 0, 3], True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_parallel_step_matches_jax(case):
    """One B-view step: the metrics, every post-Adam parameter and moment
    and the statistics within 1e-6 of each array's max; with the exposure,
    each view's row applies and the rows of the batch train."""
    views, use_exp = STEP_CASES[case]
    params, is_bez, alive, gts, jcams, pcams = _problem()
    jpipe = JPipe(backend="reference", tile_capacity=TILE_K)
    pipe = PipelineConfig(tile_capacity=TILE_K)
    with jax_x64(), exact_sort():
        jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
        s0 = _numpy_ts(jts)
        jsel = [jcams[v] for v in views]
        jts, jm = jps.parallel_train_step(
            jts, jps.camera_batch_arrays(jsel), jnp.asarray(gts[views]), jnp.zeros(()), JOpt(),
            jpipe, use_mask=True, mesh_shape=MESH1, cam_geom=_geom(jsel), conn_on=True,
            view_indices=jnp.asarray(views, jnp.int32) if use_exp else None,
            use_exposure=use_exp)
        ref = _numpy_ts(jts)
        jm = {k: np.array(v) for k, v in jm.items()}
    psel = [pcams[v] for v in views]
    with exact_sort():
        ts, pm = pps.parallel_train_step(
            _port_ts(s0), pps.camera_batch_arrays(psel), tt(gts[views]), 0.0,
            OptimizationConfig(), pipe, use_mask=True, mesh_shape=MESH1, cam_geom=_geom(psel),
            conn_on=True, view_indices=views if use_exp else None, use_exposure=use_exp)
    _assert_metrics_match(pm, jm)
    _assert_state_matches(ts, ref, F64_TOL)
    assert float(ts.xyz_grad_accum.max()) > 0 and ts.step == 1
    expo = ts.params["exposure"].numpy()
    trained = [v for v in range(len(EYES)) if not np.array_equal(expo[v], EXPOSURE[v])]
    assert trained == (sorted(views) if use_exp else [])


# ---------------------------------------------------------------------------
# (b) the chunk
# ---------------------------------------------------------------------------

K, B = 3, 2
TABLE = [[1, 3], [0, 1], [2, 0]]


@pytest.fixture(scope="module")
def chunk_reference():
    """The JAX scan of K steps of B views over TABLE, with every step
    active and with n_active = 2 (one compile: n_active is traced)."""
    params, is_bez, alive, gts, jcams, _ = _problem(seed=1)
    out = {}
    with jax_x64(), exact_sort():
        w2c, proj, ctr = jps.camera_batch_arrays(jcams)
        vi = jnp.asarray(TABLE, jnp.int32)
        for n in (K, 2):
            jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
            s0 = _numpy_ts(jts)
            jts, jm = jps.parallel_train_steps_scan(
                jts, (w2c[vi], proj[vi], ctr[vi]), jnp.asarray(gts)[vi], jnp.zeros(()), JOpt(),
                JPipe(backend="reference", tile_capacity=TILE_K), use_mask=False,
                mesh_shape=MESH1, cam_geom=_geom(jcams), n_active=jnp.asarray(n, jnp.int32))
            out[n] = (_numpy_ts(jts), {k: np.array(v) for k, v in jm.items()})
    return s0, gts, out


@pytest.mark.parametrize("n_active", [K, 2])
def test_parallel_chunk_matches_jax(chunk_reference, n_active):
    """The port's chunk from the per-step arrays [K, B, ...] (the JAX
    function's form) and from stacks of all views with the [K, B] table
    (the driver's): each step's metrics and the final state as the JAX
    scan's; steps past n_active leave the state as it is."""
    s0, gts, out = chunk_reference
    ref, jm = out[n_active]
    _, _, _, _, _, pcams = _problem(seed=1)
    stacks = pps.camera_batch_arrays(pcams)
    vi = torch.tensor(TABLE)
    with exact_sort():
        runs = [
            pps.parallel_train_steps_scan(
                _port_ts(s0), tuple(a[vi] for a in stacks), tt(gts)[vi], 0.0,
                OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K), use_mask=False,
                mesh_shape=MESH1, cam_geom=_geom(pcams), n_active=n_active),
            pps.parallel_train_steps_scan(
                _port_ts(s0), stacks, tt(gts), 0.0, OptimizationConfig(),
                PipelineConfig(tile_capacity=TILE_K), use_mask=False, mesh_shape=MESH1,
                cam_geom=_geom(pcams), n_active=n_active, rows=TABLE),
        ]
    for ts, pm in runs:
        assert all(v.shape == (K,) for v in pm.values())
        for i in range(K):
            _assert_metrics_match({k: v[i] for k, v in pm.items()},
                                  {k: v[i] for k, v in jm.items()})
        _assert_state_matches(ts, ref, F64_TOL)
    _assert_states_equal(runs[0][0], runs[1][0])


# ---------------------------------------------------------------------------
# (c) the chunk's eager body against single steps; (d) B = 1
# ---------------------------------------------------------------------------


def _port_problem(dtype, seed=2):
    params, is_bez, alive, gts, _, pcams = _problem(seed)
    with jax_x64():
        s0 = _numpy_ts(jtrain.init_train_state(jax_state(params, is_bez, alive)))
    cams = [dataclasses.replace(c, **{f: getattr(c, f).to(dtype) for f in
                                      ("world_to_cam", "full_proj", "cam_center")})
            for c in pcams]
    return _port_ts(s0, dtype), cams, tt(gts, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunk_equals_parallel_steps(dtype):
    """The chunk (rows table, exposure, frozen opacity, n_active < K) is
    bitwise K calls of parallel_train_step; the input state unchanged."""
    ts, cams, gts = _port_problem(dtype)
    ts = dataclasses.replace(ts, opacity_frozen=True)
    before = {k: v.clone() for k, v in ptrain._state_leaves(ts).items()}
    table = [[3, 0], [1, 2], [0, 3], [2, 2]]
    kw = dict(use_mask=True, mesh_shape=None, cam_geom=_geom(cams), conn_on=True,
              use_exposure=True)
    stacks = pps.camera_batch_arrays(cams)
    sts, sm = pps.parallel_train_steps_scan(ts, stacks, gts, 0.0, OptimizationConfig(),
                                            PipelineConfig(tile_capacity=TILE_K), n_active=3,
                                            view_indices=table, rows=table, **kw)
    lts = ts
    for i, row in enumerate(table):
        new, m = pps.parallel_train_step(lts, tuple(a[row] for a in stacks), gts[row], 0.0,
                                         OptimizationConfig(),
                                         PipelineConfig(tile_capacity=TILE_K),
                                         view_indices=row, **kw)
        assert list(sm) == list(m)
        for k, v in m.items():
            assert sm[k][i].item() == v.to(torch.float64).item(), (i, k)
        if i < 3:
            lts = new
    _assert_states_equal(sts, lts)
    assert sts.step == 3 and torch.equal(sts.params["opacity_raw"], ts.params["opacity_raw"])
    for k, v in ptrain._state_leaves(ts).items():
        assert torch.equal(v, before[k]), f"the input state's {k} changed"


@pytest.mark.parametrize("use_exp", [False, True])
def test_one_view_batch_equals_train_step(use_exp):
    """At B = 1 the batched step is train_step bitwise: the state and the
    metrics the two share."""
    ts, cams, gts = _port_problem(torch.float64, seed=3)
    kw = dict(use_mask=True, conn_on=True, use_exposure=use_exp)
    bts, bm = pps.parallel_train_step(ts, pps.camera_batch_arrays(cams[2:3]), gts[2:3], 0.0,
                                      OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
                                      mesh_shape=MESH1, cam_geom=_geom(cams),
                                      view_indices=[2] if use_exp else None, **kw)
    tts, tm = ptrain.train_step(ts, cams[2], gts[2], 0.0, OptimizationConfig(),
                                PipelineConfig(tile_capacity=TILE_K), n_gaussians=M,
                                view_idx=2 if use_exp else None, **kw)
    _assert_states_equal(bts, tts)
    assert set(bm) == set(METRICS) and set(bm) < set(tm)
    for k in METRICS:
        assert torch.equal(bm[k], tm[k]), k


def test_cameras_stack_and_index():
    """stack_cameras / index_camera, intrinsics included; mixed sizes and
    a mesh of more devices than the process group's ranks raise."""
    cams = psyn.ring_cameras(3, 16, 24, device="cpu")
    intr = [dataclasses.replace(c, intrinsics=torch.tensor([float(i)] * 4))
            for i, c in enumerate(cams)]
    st = pcam.stack_cameras(intr)
    assert st.world_to_cam.shape == (3, 4, 4) and st.intrinsics.shape == (3, 4)
    one = pcam.index_camera(st, 1)
    assert torch.equal(one.full_proj, cams[1].full_proj) and float(one.intrinsics[0]) == 1.0
    assert pps.batch_cameras(cams).intrinsics is None
    with pytest.raises(ValueError, match="one image size"):
        pcam.stack_cameras(cams + psyn.ring_cameras(1, 16, 32, device="cpu"))
    with pytest.raises(RuntimeError, match="needs 2 ranks and this process has no process"):
        pps.camera_batch_arrays(cams, pps.make_mesh(2, device="cpu"))


# ---------------------------------------------------------------------------
# (e) the driver
# ---------------------------------------------------------------------------

DRIVER_OPT = dict(iterations=8, densify_from_iter=2, densify_until_iter=4, conn_from_iter=3,
                  densification_interval=2, split_interval=4, merge_interval=4,
                  prune_trim_interval=4)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """Both packages' train_scene at views_per_step=2 on one scene (32x128,
    8 views, capacity 64, 8 iterations, scan_chunk=4), with the view tables
    each drew and the JAX curve counts after each surgery."""
    scene = psyn.make_scene(seed=1, n_curves=2, n_lines=1, n_views=8, height=32, width=128,
                            capacity=64, device="cpu")
    maps = [e.numpy() for e in scene.edge_maps]
    jcams = jsyn.ring_cameras(8, 32, 128)
    seeds = scene.curves.mean(axis=1).astype(np.float32)
    out = tmp_path_factory.mktemp("views")
    kw = dict(quiet=True, scan_chunk=4, seed=5, views_per_step=2, test_iterations=(),
              log_every=1)
    rec = {"jax": [], "port": [], "jax_counts": []}
    jscan, pscan, apply = (jps.parallel_train_steps_scan, ploop.parallel_train_steps_scan,
                           jsurg.apply_schedule)

    def jscan_rec(*a, n_active=None, view_indices=None, **k):
        rec["jax"].append(np.asarray(view_indices)[: int(n_active)].tolist())
        return jscan(*a, n_active=n_active, view_indices=view_indices, **k)

    def pscan_rec(*a, rows=None, **k):
        rec["port"].append(rows)
        return pscan(*a, rows=rows, **k)

    def apply_rec(ts, it, opt):
        new = apply(ts, it, opt)
        if new is not ts:
            rec["jax_counts"].append((it, int(jnp.sum(new.alive))))
        return new

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "parallel_train_steps_scan", jscan_rec)
        mp.setattr(ploop, "parallel_train_steps_scan", pscan_rec)
        mp.setattr(jsurg, "apply_schedule", apply_rec)
        jres = jloop.train_scene(
            jcams, maps, seeds, JModel(n_gaussians=8, train_test_exp=True), JOpt(**DRIVER_OPT),
            JPipe(backend="reference", tile_capacity=128), str(out / "jax"), n_devices=1, **kw)
        pres = ploop.train_scene(
            scene.cameras, maps, seeds, ModelConfig(n_gaussians=8, train_test_exp=True),
            OptimizationConfig(**DRIVER_OPT), PipelineConfig(tile_capacity=128),
            str(out / "port"), device="cpu", **kw)
    return jres, pres, rec


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_driver_views_and_surgery_match_jax(driver_runs):
    jres, pres, rec = driver_runs
    assert rec["port"] == rec["jax"] and len(rec["port"]) >= 3
    assert [len(r) for t in rec["port"] for r in t] == [2] * 8
    port = [(e["iter"], e["curves"]) for e in pres.events if e["kind"] == "surgery"]
    assert port == rec["jax_counts"] and len(port) >= 2
    assert int(pres.ts.step) == int(jres.ts.step) == 8
    assert pres.ts.alive.shape[0] == jres.ts.alive.shape[0]
    assert not [e for e in pres.events if e["kind"] == "big_capacity"]
    assert len(pres.graphs.captures) == 0  # the CPU runs the body eagerly


def test_driver_logged_losses_match_jax(driver_runs):
    jres, pres, _ = driver_runs
    jrows, prows = _rows(jres.metrics_path), _rows(pres.metrics_path)
    assert [r["iter"] for r in prows] == [r["iter"] for r in jrows] and jrows
    for jr, pr in zip(jrows, prows):
        assert set(METRICS) <= set(pr) and "big_peak" not in pr
        assert abs(pr["total"] - jr["total"]) <= LOSS_TOL["total"] * abs(jr["total"]), jr["iter"]
        for k in METRICS[1:]:
            assert pr[k] == jr[k], (jr["iter"], k)


def test_driver_more_devices_raise():
    """views_per_step over more devices than this process's group (none)
    raises with the launch to make, where the JAX driver would quietly
    take fewer."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        ploop.train_scene([], [], np.zeros((4, 3)), ModelConfig(), OptimizationConfig(),
                          PipelineConfig(), "unused", views_per_step=2, n_devices=2,
                          device="cpu")
