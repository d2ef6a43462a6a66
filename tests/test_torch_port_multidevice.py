"""More than one device on the CPU: two ranks of a ``torch.distributed``
process group (gloo), each a process this module starts
(``parallel/multihost.py::run_ranks``, a ``file://`` rendezvous under
tmp_path, one torch thread each, every join bounded and the ranks killed
when it runs out), held against the JAX package and against the port in
one process:

(a) the two-rank ``parallel_train_step`` (float64, 4 views, 2 a rank, with
    exposure, mask and connectivity) against the JAX
    ``parallel_train_step`` at ``mesh_shape=(("data", 2),)`` on the virtual
    devices of ``tests/conftest.py``, the JAX side on
    ``backend="reference"``: each array within ``F64_TOL`` (1e-6 of its
    max);
(b) against the port's own one-process B-view step: B = 2 over 2 ranks
    bitwise in float32 (a sum of two terms commutes), B = 4 within
    ``F64_TOL`` in float64, and a chunk of K = 3 steps with ``n_active`` =
    2 both ways, run through the one body of a multi-rank step (local sums,
    exchange, update: what the card captures as one graph over NCCL);
(c) ``train_scene(n_devices=2, views_per_step=2)`` across surgery: the
    ranks' final states bitwise equal, the run equal to the one-process
    B = 2 run (view tables, curve counts after every event, logged
    metrics, final state) and its files written by rank 0 alone;
(d) ``tile_parallel_render`` at a ragged height (80 rows over 2 ranks:
    64-row bands, the second cropped) within 2e-5 (the tolerance of
    ``tests/test_parallel.py``'s row-sharded render) of the port's
    ``eval_render`` and of the JAX ``eval_render(backend="reference")``,
    and ``render_curves --n-devices 2`` within 2e-5 of one process, its
    frames written by rank 0 alone; ``tile_parallel_renders`` (the body the
    card captures per band, the sum inside, and replays per view)
    bitwise equal to ``tile_parallel_render_gaussians`` of each view, and
    the two-rank frames' SHA-256 those of one process;
(e) ``dryrun_multichip(2)`` passes every stage;
(f) ``shard_scans`` as the JAX function, ``initialize_distributed`` a
    no-op for one process, and a mesh of another size than the group
    raising.

The ranks start once: a module fixture runs every case in them and reads
their results from tmp_path, while this process computes the references.
The module imports no JAX at its top: the ranks run it as a script.
"""
import json
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.engine import spans
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops.camera import Camera
from curve_gaussian_tpu_torch.parallel import dryrun as pdry
from curve_gaussian_tpu_torch.parallel import multihost as pmh
from curve_gaussian_tpu_torch.parallel import sharding as pps
from curve_gaussian_tpu_torch.scripts import render_curves as prc

RANKS = 2
TIMEOUT_S = 150  # the ranks' whole run; they finish in ~15 s alone
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_K = 136  # test_torch_port_views.py's
B4_VIEWS = [2, 0, 3, 1]  # (a), (b): 2 views a rank
B2_VIEWS = [0, 1]
TABLE2 = [[1, 3], [0, 1], [2, 0]]  # (b): K = 3 steps, n_active = 2
TABLE4 = [[1, 3, 0, 2], [0, 1, 3, 2], [2, 0, 1, 3]]
N_ACTIVE = 2
RENDER_HW = (80, 96)  # (d): a ragged height for 2 x 32-row tiles
RENDER_VIEWS = [1, 0, 1]  # (d): rows of the two render cameras' stacks
RENDER_TOL = 2e-5
DRIVER_OPT = dict(iterations=8, densify_from_iter=2, densify_until_iter=4, conn_from_iter=3,
                  densification_interval=2, split_interval=4, merge_interval=4,
                  prune_trim_interval=4)
CURVES_ARGS = ["--size", "48", "--n-orbit", "2", "--device", "cpu"]


# ---------------------------------------------------------------------------
# what each rank runs (no JAX here)
# ---------------------------------------------------------------------------


def _port_ts(s0, dtype):
    return convert.train_state_from_numpy(
        s0["params"], s0["mu"], s0["nu"], s0["count"], s0["is_bezier"], s0["alive"],
        s0["xyz_grad_accum"], s0["denom"], s0["max_radii"], s0["step"],
        s0["opacity_frozen"], device="cpu", dtype=dtype)


def _cams(inp, dtype):
    return [Camera(world_to_cam=torch.tensor(w, dtype=dtype),
                   full_proj=torch.tensor(p, dtype=dtype),
                   cam_center=torch.tensor(c, dtype=dtype), height=inp["H"], width=inp["W"],
                   tanfovx=inp["tan"][0], tanfovy=inp["tan"][1]) for w, p, c in inp["cams"]]


def _leaves(ts):
    out = {k: v.numpy().copy() for k, v in ptrain._state_leaves(ts).items()}
    out["step"], out["count"] = ts.step, ts.opt.count
    return out


def _metrics(m):
    return {k: np.asarray(v.to(torch.float64)) for k, v in m.items()}


class _Writes:
    """The files and directories a process creates or opens for writing
    under `root`, from the interpreter's audit events."""

    def __init__(self, root):
        self.root, self.paths, self.on = os.path.abspath(root), [], False
        sys.addaudithook(self)

    def __call__(self, event, args):
        if not self.on or event not in ("open", "os.mkdir", "os.rename", "os.replace"):
            return
        path = args[0]
        if event == "open":
            mode, flags = args[1], args[2]
            writing = (any(c in mode for c in "wax+") if isinstance(mode, str)
                       else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if not writing:
                return
        if isinstance(path, (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(path))
            if path.startswith(self.root):
                self.paths.append(os.path.relpath(path, self.root))


def _steps(inp, mesh):
    """(a), (b): the two-rank step and chunk."""
    out = {}
    kw = dict(use_mask=True, conn_on=True, use_exposure=True)
    old = pbin.SORT_PACKED
    pbin.SORT_PACKED = False  # the exact depth order, as the JAX side's exact_sort
    try:
        for name, views, dtype in (("B4", B4_VIEWS, torch.float64),
                                   ("B2", B2_VIEWS, torch.float32)):
            cams, gts = _cams(inp, dtype), torch.tensor(inp["gts"], dtype=dtype)
            mine = mesh.block(views)
            ts, m = pps.parallel_train_step(
                _port_ts(inp["s0"], dtype), pps.camera_batch_arrays([cams[v] for v in mine]),
                gts[mine], 0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
                mesh_shape=mesh.shape, cam_geom=inp["geom"], view_indices=mine, **kw)
            out[f"step_{name}"] = (_leaves(ts), _metrics(m))
        # the chunk: B = 2 from the stacks with the table's rows (the driver's form, with
        # exposure), B = 4 from per-step arrays (the JAX function's form)
        cams, gts = _cams(inp, torch.float32), torch.tensor(inp["gts"], dtype=torch.float32)
        rows = [mesh.block(r) for r in TABLE2]
        ts, m = pps.parallel_train_steps_scan(
            _port_ts(inp["s0"], torch.float32), pps.camera_batch_arrays(cams), gts, 0.0,
            OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K), mesh_shape=mesh.shape,
            cam_geom=inp["geom"], n_active=N_ACTIVE, view_indices=rows, rows=rows, **kw)
        out["chunk_B2"] = (_leaves(ts), _metrics(m))
        # the same chunk's first two steps with device spans on
        s0 = _port_ts(inp["s0"], torch.float32)
        live = [k for k in s0.params if k not in ptrain.dead_groups(True)]
        P = s0.max_radii.shape[0]
        out["exchange_numel"] = (sum(s0.params[k].numel() for k in live) + 3 * P + 4, P + 1)
        g = ptrain.StepGraphs(pps.batch_step(RANKS), spans=True)
        pps.parallel_train_steps_scan(
            s0, pps.camera_batch_arrays(cams), gts, 0.0, OptimizationConfig(),
            PipelineConfig(tile_capacity=TILE_K), mesh_shape=mesh.shape,
            cam_geom=inp["geom"], view_indices=rows[:2], rows=rows[:2], graphs=g, **kw)
        names, table = g.last_stamps
        out["spans"] = dict(names=names, table=table.numpy(), ms=g.span_ms(),
                            exchange_bytes=g.exchange_bytes)
        cams, gts = _cams(inp, torch.float64), torch.tensor(inp["gts"], dtype=torch.float64)
        vi = torch.tensor([mesh.block(r) for r in TABLE4])
        ts, m = pps.parallel_train_steps_scan(
            _port_ts(inp["s0"], torch.float64), tuple(a[vi] for a in pps.camera_batch_arrays(cams)),
            gts[vi], 0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
            use_mask=False, mesh_shape=mesh.shape, cam_geom=inp["geom"], n_active=N_ACTIVE)
        out["chunk_B4"] = (_leaves(ts), _metrics(m))
    finally:
        pbin.SORT_PACKED = old
    return out


def _driver_scene():
    scene = psyn.make_scene(seed=1, n_curves=2, n_lines=1, n_views=8, height=32, width=128,
                            capacity=64, device="cpu")
    return scene, [e.numpy() for e in scene.edge_maps], scene.curves.mean(axis=1).astype(
        np.float32)


def _driver(model_path, n_devices=None):
    """(c): train_scene at 2 views a step, with the tables it trained on."""
    scene, maps, seeds = _driver_scene()
    tables = []
    scan = ploop.parallel_train_steps_scan

    def recording(*a, rows=None, **k):
        tables.append(rows)
        return scan(*a, rows=rows, **k)

    ploop.parallel_train_steps_scan = recording
    try:
        res = ploop.train_scene(
            scene.cameras, maps, seeds, ModelConfig(n_gaussians=8, train_test_exp=True),
            OptimizationConfig(**DRIVER_OPT), PipelineConfig(tile_capacity=128), model_path,
            test_cameras=scene.cameras[:2], test_edge_maps=maps[:2], test_iterations=(8,),
            save_iterations=(8,), checkpoint_iterations=(4,), quiet=True, scan_chunk=4,
            seed=5, views_per_step=2, n_devices=n_devices, log_every=1, device="cpu")
    finally:
        ploop.parallel_train_steps_scan = scan
    events = [{k: v for k, v in e.items() if k not in ("seconds", "op_seconds")}
              for e in res.events]
    return dict(leaves=_leaves(res.ts), events=events, tables=tables,
                edges=res.edge_dict)


def _raises(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _rank(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    writes = _Writes(work)
    pmh.initialize_distributed(f"file://{os.path.join(work, 'rendezvous')}", RANKS, rank,
                               device="cpu")
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = pps.make_mesh(RANKS, device="cpu")
    out = _steps(inp, mesh)

    writes.on = True
    out["driver"] = _driver(os.path.join(work, "driver"), n_devices=RANKS)
    res = prc.render_curves(["--edges", os.path.join(work, "edges.json"), "--out",
                             os.path.join(work, "curves_tp"), "--n-devices", str(RANKS)]
                            + CURVES_ARGS, quiet=True)
    writes.on = False
    out["writes"] = writes.paths
    out["curves_frame0"] = res["first_frame"]
    out["curves_sha"] = res["sha256"]

    ts = _port_ts(inp["s0"], torch.float32)
    H, W = RENDER_HW
    pipe = PipelineConfig(tile_capacity=TILE_K)
    out["tile_render"] = pps.tile_parallel_render(
        ts, tuple(torch.tensor(a, dtype=torch.float32) for a in inp["render_cam"]),
        (H, W, *inp["render_tan"]), pipe, 0.0, mesh.shape,
        n_gaussians=ts.params["mask_raw"].shape[1]).numpy()
    rcams = [Camera(*(torch.tensor(a, dtype=torch.float32) for a in c), H, W, *inp["render_tan"])
             for c in (inp["render_cam"], inp["render_cam2"])]
    with torch.no_grad():
        gauss = pcs.gaussians(pcs.curve_state_of(ts))
    out["tile_renders"] = [f.numpy() for f in pps.tile_parallel_renders(
        gauss, ptrain.camera_stacks(rcams, torch.float32, "cpu"), (H, W, *inp["render_tan"]),
        pipe, 0.0, mesh.shape, RENDER_VIEWS)]
    out["tile_render_each"] = [pps.tile_parallel_render_gaussians(
        gauss, rcams[v], pipe, 0.0, mesh.shape).numpy() for v in RENDER_VIEWS]
    out["dryrun"] = pdry.dryrun_multichip(RANKS, "cpu")
    scene, maps, seeds = _driver_scene()
    out["raises"] = {
        "mesh_of_3": _raises(lambda: pps.make_mesh(3, device="cpu")),
        "step_mesh_of_4": _raises(lambda: pps.parallel_train_step(
            ts, pps.camera_batch_arrays(_cams(inp, torch.float32)[:1]),
            torch.zeros((1, inp["H"], inp["W"])), 0.0, OptimizationConfig(), PipelineConfig(),
            use_mask=False, mesh_shape=(("data", 4),), cam_geom=inp["geom"])),
        "views_3": _raises(lambda: ploop.train_scene(
            scene.cameras, maps, seeds, ModelConfig(n_gaussians=8), OptimizationConfig(),
            PipelineConfig(), os.path.join(work, "unused"), views_per_step=3, n_devices=2,
            device="cpu")),
    }
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references, in this process, while the ranks run
# ---------------------------------------------------------------------------


def _jax_state_leaves(jts):
    from test_torch_port_step import _numpy_ts

    s = _numpy_ts(jts)
    out = {f"{g}/{k}": v for g in ("params", "mu", "nu") for k, v in s[g].items()}
    out.update({k: s[k] for k in ("is_bezier", "alive", "xyz_grad_accum", "denom",
                                  "max_radii", "step", "count")})
    return out


def _references(inp, jax_inputs, work):
    import jax.numpy as jnp

    from curve_gaussian_tpu.config import OptimizationConfig as JOpt
    from curve_gaussian_tpu.config import PipelineConfig as JPipe
    from curve_gaussian_tpu.engine import train as jtrain
    from curve_gaussian_tpu.parallel import sharding as jps
    from test_torch_port_geometry import exact_sort, jax_state, jax_x64

    params, is_bez, alive, jcams, rcam = jax_inputs
    ref = {}
    geom = inp["geom"]
    with jax_x64(), exact_sort():
        jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
        sel = [jcams[v] for v in B4_VIEWS]
        jts, jm = jps.parallel_train_step(
            jts, jps.camera_batch_arrays(sel), jnp.asarray(inp["gts"][B4_VIEWS]),
            jnp.zeros(()), JOpt(), JPipe(backend="reference", tile_capacity=TILE_K),
            use_mask=True, mesh_shape=(("data", RANKS),), cam_geom=geom, conn_on=True,
            view_indices=jnp.asarray(B4_VIEWS, jnp.int32), use_exposure=True)
        ref["jax_step"] = (_jax_state_leaves(jts), {k: np.array(v) for k, v in jm.items()})

        # the port at one process: the same steps and chunks, mesh_shape None
        kw = dict(use_mask=True, conn_on=True, use_exposure=True)
        for name, views, dtype in (("B4", B4_VIEWS, torch.float64),
                                   ("B2", B2_VIEWS, torch.float32)):
            cams, gts = _cams(inp, dtype), torch.tensor(inp["gts"], dtype=dtype)
            ts, m = pps.parallel_train_step(
                _port_ts(inp["s0"], dtype), pps.camera_batch_arrays([cams[v] for v in views]),
                gts[views], 0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
                mesh_shape=None, cam_geom=geom, view_indices=views, **kw)
            ref[f"step_{name}"] = (_leaves(ts), _metrics(m))
        cams, gts = _cams(inp, torch.float32), torch.tensor(inp["gts"], dtype=torch.float32)
        ts, m = pps.parallel_train_steps_scan(
            _port_ts(inp["s0"], torch.float32), pps.camera_batch_arrays(cams), gts, 0.0,
            OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K), mesh_shape=None,
            cam_geom=geom, n_active=N_ACTIVE, view_indices=TABLE2, rows=TABLE2, **kw)
        ref["chunk_B2"] = (_leaves(ts), _metrics(m))
        cams, gts = _cams(inp, torch.float64), torch.tensor(inp["gts"], dtype=torch.float64)
        vi = torch.tensor(TABLE4)
        ts, m = pps.parallel_train_steps_scan(
            _port_ts(inp["s0"], torch.float64), tuple(a[vi] for a in pps.camera_batch_arrays(cams)),
            gts[vi], 0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
            use_mask=False, mesh_shape=None, cam_geom=geom, n_active=N_ACTIVE)
        ref["chunk_B4"] = (_leaves(ts), _metrics(m))

    # (d): the one-device renders of the same state and view
    H, W = RENDER_HW
    ts = _port_ts(inp["s0"], torch.float32)
    cam = Camera(*(torch.tensor(a, dtype=torch.float32) for a in inp["render_cam"]), H, W,
                 *inp["render_tan"])
    with torch.no_grad():
        ref["eval_render"] = ptrain.eval_render(ts, cam, PipelineConfig(tile_capacity=TILE_K),
                                                0.0)["render"].numpy()
    jts = jtrain.init_train_state(jax_state(params, is_bez, alive, dtype=jnp.float32))
    ref["jax_eval_render"] = np.array(jtrain.eval_render(
        jts, rcam, JPipe(backend="reference", tile_capacity=TILE_K), jnp.zeros(()),
        n_gaussians=params["mask_raw"].shape[1])["render"])
    one = prc.render_curves(
        ["--edges", os.path.join(work, "edges.json"), "--out", os.path.join(work, "curves_one")]
        + CURVES_ARGS, quiet=True)
    ref["curves_frame0"], ref["curves_sha"] = one["first_frame"], one["sha256"]
    ref["driver"] = _driver(os.path.join(work, "driver_one"))
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results and this process's references."""
    from curve_gaussian_tpu.engine import train as jtrain
    from test_torch_port_geometry import cam_pair, jax_state, jax_x64
    from test_torch_port_step import _numpy_ts
    from test_torch_port_views import _problem

    work = str(tmp_path_factory.mktemp("ranks"))
    params, is_bez, alive, gts, jcams, _ = _problem()
    with jax_x64():
        s0 = _numpy_ts(jtrain.init_train_state(jax_state(params, is_bez, alive)))
    H, W = RENDER_HW
    rcam, _ = cam_pair([0.0, -0.3, -1.2], [0, 0, 0], H, W, dtype=np.float32)  # fills both bands
    rcam2, _ = cam_pair([0.4, -0.2, -1.3], [0, 0, 0], H, W, dtype=np.float32)
    inp = dict(s0=s0, gts=gts, H=gts.shape[1], W=gts.shape[2],
               tan=(float(jcams[0].tanfovx), float(jcams[0].tanfovy)),
               geom=(gts.shape[1], gts.shape[2], float(jcams[0].tanfovx),
                     float(jcams[0].tanfovy)),
               cams=[tuple(np.asarray(a, np.float64) for a in
                           (c.world_to_cam, c.full_proj, c.cam_center)) for c in jcams],
               render_cam=tuple(np.asarray(a) for a in
                                (rcam.world_to_cam, rcam.full_proj, rcam.cam_center)),
               render_cam2=tuple(np.asarray(a) for a in
                                 (rcam2.world_to_cam, rcam2.full_proj, rcam2.cam_center)),
               render_tan=(float(rcam.tanfovx), float(rcam.tanfovy)))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    cp, is_b = psyn.random_curves(np.random.default_rng(4), 3, 1)
    with open(os.path.join(work, "edges.json"), "w") as f:
        json.dump({"curves_ctl_pts": cp[is_b].reshape(-1, 12).tolist(),
                   "lines_end_pts": cp[~is_b][:, [0, 3]].reshape(-1, 6).tolist()}, f)

    env = {k: v for k, v in os.environ.items()
           if k not in ("CGT_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, os.path.abspath(__file__), str(r), work] for r in range(RANKS)]
    done = {}
    t = threading.Thread(target=lambda: done.update(
        res=pmh.run_ranks(cmds, TIMEOUT_S, env=env, cwd=ROOT)))
    t.start()
    old = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks, so that the one-process driver run is comparable
    try:
        ref = _references(inp, (params, is_bez, alive, jcams, rcam), work)
    finally:
        torch.set_num_threads(old)
        t.join(TIMEOUT_S + 30)
    assert not t.is_alive(), "the ranks' launcher did not return"
    bad = pmh.failures(done["res"])
    assert not bad, bad
    out = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out, ref, work


# ---------------------------------------------------------------------------
# (a), (b): the step and the chunk
# ---------------------------------------------------------------------------


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    m = np.abs(b).max() if b.size else 0.0
    d = np.abs(a - b).max() if a.size else 0.0
    return d / m if m > 0 else d


def _assert_close(got, want, tol):
    (gl, gm), (wl, wm) = got, want
    assert set(gl) == set(wl)
    for k in wl:
        assert _max_rel(gl[k], wl[k]) <= tol, k
    assert set(gm) == set(wm)
    for k in wm:
        assert _max_rel(gm[k], wm[k]) <= tol, k


def _assert_equal(got, want):
    (gl, gm), (wl, wm) = got, want
    assert set(gl) == set(wl) and set(gm) == set(wm)
    for k in wl:
        assert np.array_equal(gl[k], wl[k]) and np.asarray(gl[k]).dtype == np.asarray(
            wl[k]).dtype, k
    for k in wm:
        assert np.array_equal(gm[k], wm[k]), k


def test_two_rank_step_matches_jax(ranks):
    """(a): both ranks' step against the JAX step over a 2-device mesh."""
    from test_torch_port_step import F64_TOL

    out, ref, _ = ranks
    for r in out:
        _assert_close(r["step_B4"], ref["jax_step"], F64_TOL)
    assert out[0]["step_B4"][0]["step"] == 1


@pytest.mark.parametrize("case", ["step_B2", "step_B4", "chunk_B2", "chunk_B4"])
def test_two_ranks_match_one_process(ranks, case):
    """(b): B = 2 in float32 bitwise, B = 4 in float64 within F64_TOL; the
    two ranks bitwise equal either way.  The chunks run the one body of the
    multi-rank step (local sums, exchange, update), which the card
    captures as one graph."""
    from test_torch_port_step import F64_TOL

    out, ref, _ = ranks
    _assert_equal(out[0][case], out[1][case])
    if case.endswith("B2"):
        _assert_equal(out[0][case], ref[case])
    else:
        _assert_close(out[0][case], ref[case], F64_TOL)
    if case.startswith("chunk"):
        leaves, metrics = out[0][case]
        assert leaves["step"] == N_ACTIVE and all(v.shape == (3,) for v in metrics.values())


def test_exchange_span_two_ranks(ranks):
    """(b): a two-rank step with device spans on (one view a rank): each
    view's marks, then the stamp before the SUM closes ``adam``, the one
    after the MAX closes ``exchange``, and the update's end ``adam`` again;
    the stamps are ordered and tile the step; the seven spans, exchange
    last; the bytes a step exchanges are the SUM and MAX buffers'."""
    from test_torch_port_spans import VIEW_MARKS

    out, _, _ = ranks
    for r in out:
        got = r["spans"]
        assert got["names"] == VIEW_MARKS + ("adam", spans.EXCHANGE, "adam")
        t = got["table"][:, : len(got["names"]) + 1]
        d = t[:, 1:] - t[:, :-1]
        assert t.shape[0] == 2 and (d >= 0).all() and (t[:, -1] > t[:, 0]).all()
        j = len(VIEW_MARKS) + 1  # the column of the stamp after the MAX
        assert (t[:, j - 1] >= t[:, : j - 1].max(axis=1)).all()
        assert (t[:, j] <= t[:, j + 1:].min(axis=1)).all()
        assert list(got["ms"]) == list(spans.SPANS) + [spans.EXCHANGE]
        assert sum(got["ms"].values()) == pytest.approx(d.sum() / 2 * 1e-6, rel=1e-12)
        assert got["exchange_bytes"] == 4 * sum(r["exchange_numel"])


# ---------------------------------------------------------------------------
# (c) the driver
# ---------------------------------------------------------------------------


def test_driver_ranks_hold_one_state(ranks):
    out, _, _ = ranks
    a, b = out[0]["driver"]["leaves"], out[1]["driver"]["leaves"]
    assert a.keys() == b.keys() and a["step"] == DRIVER_OPT["iterations"]
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_driver_equals_one_process(ranks):
    """The view tables (each rank its column of the one-process table), the
    surgery events and curve counts, the logged metrics and the final state
    of the two-rank run are the one-process run's."""
    out, ref, work = ranks
    one = ref["driver"]
    cols = [r["driver"]["tables"] for r in out]
    assert len(cols[0]) == len(one["tables"]) >= 3
    for k, table in enumerate(one["tables"]):
        assert [a + b for a, b in zip(cols[0][k], cols[1][k])] == table
    assert out[0]["driver"]["events"] == out[1]["driver"]["events"] == one["events"]
    assert len([e for e in one["events"] if e["kind"] == "surgery"]) >= 2
    for k, v in one["leaves"].items():
        assert np.array_equal(out[0]["driver"]["leaves"][k], v), k
    assert out[0]["driver"]["edges"] == one["edges"]

    def rows(d):
        with open(os.path.join(work, d, "metrics.jsonl")) as fh:
            return [{k: v for k, v in json.loads(line).items() if k != "iter_time"}
                    for line in fh]

    got, want = rows("driver"), rows("driver_one")
    assert got == want and len(want) == DRIVER_OPT["iterations"] + 1  # and the test render


def test_driver_writes_from_rank_zero_only(ranks):
    out, _, work = ranks
    w0, w1 = out[0]["writes"], out[1]["writes"]
    assert w1 == [], w1
    for f in ("driver/metrics.jsonl", "driver/parametric_edges.json", "driver/chkpnt4.npz",
              "driver/input.ply", "driver/cameras.json", "driver/test_images/iter_000008",
              "curves_tp/frames/frame_0001.png"):
        assert any(p == f or p.startswith(f + os.sep) or p.startswith(f + ".")
                   for p in w0), (f, w0)
    assert sorted(os.listdir(os.path.join(work, "curves_tp", "frames"))) == [
        "frame_0000.png", "frame_0001.png"]


# ---------------------------------------------------------------------------
# (d) the tile-parallel render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("against", ["eval_render", "jax_eval_render"])
def test_tile_parallel_render_ragged(ranks, against):
    out, ref, _ = ranks
    img = out[0]["tile_render"]
    assert np.array_equal(img, out[1]["tile_render"]) and img.shape == RENDER_HW
    assert img[:64].max() > 0.05 and img[64:].max() > 0.05  # both bands render curves
    assert np.abs(img - ref[against]).max() <= RENDER_TOL


def test_tile_parallel_renders_replay_the_band(ranks):
    """The many-view body equals the one-view render, view by view, on
    both ranks; view 0 is the state render of (d)."""
    out, ref, _ = ranks
    for r in out:
        assert len(r["tile_renders"]) == len(RENDER_VIEWS)
        for got, want in zip(r["tile_renders"], r["tile_render_each"]):
            assert np.array_equal(got, want) and got.shape == RENDER_HW
        assert np.array_equal(r["tile_renders"][1], r["tile_render"])
        for a, b in zip(r["tile_renders"], out[0]["tile_renders"]):
            assert np.array_equal(a, b)
    assert not np.array_equal(out[0]["tile_renders"][0], out[0]["tile_renders"][1])
    assert np.abs(out[0]["tile_renders"][1] - ref["eval_render"]).max() <= RENDER_TOL


def test_render_curves_over_two_ranks(ranks):
    out, ref, _ = ranks
    f0 = out[0]["curves_frame0"]
    assert np.array_equal(f0, out[1]["curves_frame0"]) and f0.shape == (48, 48)
    assert f0.max() > 0.05 and np.abs(f0 - ref["curves_frame0"]).max() <= RENDER_TOL
    assert out[0]["curves_sha"] == out[1]["curves_sha"] == ref["curves_sha"]


# ---------------------------------------------------------------------------
# (e) the dry run; (f) the multihost pieces
# ---------------------------------------------------------------------------


def test_dryrun_multichip_two_ranks(ranks):
    out, _, _ = ranks
    for r in out:
        assert r["dryrun"].startswith("dryrun_multichip(2): loss=")
        assert r["dryrun"].endswith("stages OK: step, scan-chunk, surgery, capacity-rebucket, "
                                    "checkpoint-roundtrip, tile-parallel-render")


def test_shard_scans_matches_jax():
    from curve_gaussian_tpu.parallel import multihost as jmh

    scans = [f"scan{i:02d}" for i in range(7)]
    for n in (1, 2, 3):
        for pid in range(n):
            assert pmh.shard_scans(scans, pid, n) == jmh.shard_scans(scans, pid, n)


def test_initialize_distributed_one_process(monkeypatch):
    for k in ("CGT_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pmh.initialize_distributed() == 0 and not dist.is_initialized()
    assert pmh.initialize_distributed(num_processes=1, process_id=3) == 0
    mesh = pmh.global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, (("data", 1),))


def test_mesh_of_another_size_raises(ranks):
    """A mesh, step or driver over more devices than the group's ranks raises
    and names what to launch; so does a view count the ranks cannot split."""
    out, _, _ = ranks
    for r in out:
        got = r["raises"]
        assert "mesh of 3 devices needs 3 ranks" in got["mesh_of_3"]
        assert "a process group of 2 ranks" in got["mesh_of_3"]
        assert "mesh of 4 devices needs 4 ranks" in got["step_mesh_of_4"]
        assert "views_per_step=3 splits evenly over 1 device" in got["views_3"]
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        pps.make_mesh(2, device="cpu")


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2])
