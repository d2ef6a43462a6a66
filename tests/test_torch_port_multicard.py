"""More than one card, rehearsed on the CPU: four ranks of a gloo process
group (each a process this module starts, as
``tests/test_torch_port_multidevice.py`` starts two), and the choice
between the two forms of a multi-rank step and render.

(a) the four-rank ``parallel_train_step`` (float64, 4 views, one a rank,
    with exposure, mask and connectivity) against the JAX
    ``parallel_train_step`` at ``mesh_shape=(("data", 4),)`` on the
    virtual devices of ``tests/conftest.py`` (``backend="reference"``):
    each array within ``F64_TOL`` (1e-6 of its max), the four ranks
    bitwise equal;
(b) the fused body of the multi-rank step (local sums, exchange, update as
    one function: the body the card captures as one graph over NCCL) run
    eagerly against the staged body over a chunk of K = 3 steps with
    ``n_active`` = 2, bitwise; and the fused band render (the SUM inside
    the band's body) bitwise equal to the staged one (the SUM between the
    replays) and to the one-view render, at a height that leaves the last
    of the four 32-row bands empty;
(c) ``multihost.captures_collectives``, the predicate that picks the form:
    gloo picks the staged form, NCCL with a card per rank the fused one,
    and NCCL with more ranks on a host than cards raises (there, and in
    ``initialize_distributed`` before NCCL starts).  The backend and the
    card count are monkeypatched; nothing is captured.

The module imports no JAX at its top: the ranks run it as a script.
"""
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops.camera import Camera
from curve_gaussian_tpu_torch.parallel import multihost as pmh
from curve_gaussian_tpu_torch.parallel import sharding as pps
from test_torch_port_multidevice import (TILE_K, _assert_close, _assert_equal, _cams,
                                         _jax_state_leaves, _leaves, _metrics, _port_ts)

RANKS = 4
TIMEOUT_S = 150  # the ranks' whole run; they finish in ~10 s alone
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS = [2, 0, 3, 1]  # (a): one view a rank
TABLE = [[1, 3, 0, 2], [0, 1, 3, 2], [2, 0, 1, 3]]  # (b): K = 3 steps
N_ACTIVE = 2
RENDER_HW = (80, 96)  # (b): 32-row bands, the fourth below the image
RENDER_VIEWS = [1, 0]


# ---------------------------------------------------------------------------
# what each rank runs (no JAX here)
# ---------------------------------------------------------------------------


def _rank(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    pmh.initialize_distributed(f"file://{os.path.join(work, 'rendezvous')}", RANKS, rank,
                               backend="gloo", device="cpu")
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = pps.make_mesh(RANKS, device="cpu")
    out = {"fuses": [ptrain.StepGraphs(pps.batch_step(RANKS)).fuses(),
                     pmh.captures_collectives()]}
    kw = dict(use_mask=True, conn_on=True, use_exposure=True)
    old = pbin.SORT_PACKED
    pbin.SORT_PACKED = False  # the exact depth order, as the JAX side's exact_sort
    try:
        cams, gts = _cams(inp, torch.float64), torch.tensor(inp["gts"], dtype=torch.float64)
        mine = mesh.block(VIEWS)
        ts, m = pps.parallel_train_step(
            _port_ts(inp["s0"], torch.float64), pps.camera_batch_arrays([cams[v] for v in mine]),
            gts[mine], 0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
            mesh_shape=mesh.shape, cam_geom=inp["geom"], view_indices=mine, **kw)
        out["step"] = (_leaves(ts), _metrics(m))
        cams, gts = _cams(inp, torch.float32), torch.tensor(inp["gts"], dtype=torch.float32)
        rows = [mesh.block(r) for r in TABLE]
        for form, fused in (("staged", False), ("fused", True)):
            ts, m = pps.parallel_train_steps_scan(
                _port_ts(inp["s0"], torch.float32), pps.camera_batch_arrays(cams), gts, 0.0,
                OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K),
                mesh_shape=mesh.shape, cam_geom=inp["geom"], n_active=N_ACTIVE,
                view_indices=rows, rows=rows,
                graphs=ptrain.StepGraphs(pps.batch_step(RANKS), fused=fused), **kw)
            out[f"chunk_{form}"] = (_leaves(ts), _metrics(m))
    finally:
        pbin.SORT_PACKED = old

    ts = _port_ts(inp["s0"], torch.float32)
    H, W = RENDER_HW
    rcams = [Camera(*(torch.tensor(a, dtype=torch.float32) for a in c), H, W, *inp["render_tan"])
             for c in inp["render_cams"]]
    with torch.no_grad():
        gauss = pcs.gaussians(pcs.curve_state_of(ts))
    stacks = ptrain.camera_stacks(rcams, torch.float32, "cpu")
    pipe = PipelineConfig(tile_capacity=TILE_K)
    captures = pps.captures_collectives
    for form, fused in (("staged", False), ("fused", True)):
        pps.captures_collectives = lambda: fused  # the fused band's body, run eagerly here
        try:
            out[f"renders_{form}"] = [f.numpy() for f in pps.tile_parallel_renders(
                gauss, stacks, (H, W, *inp["render_tan"]), pipe, 0.0, mesh.shape, RENDER_VIEWS)]
        finally:
            pps.captures_collectives = captures
    out["render_each"] = [pps.tile_parallel_render_gaussians(
        gauss, rcams[v], pipe, 0.0, mesh.shape).numpy() for v in RENDER_VIEWS]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX reference, in this process, while the ranks run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results and the JAX step over four devices."""
    import jax.numpy as jnp

    from curve_gaussian_tpu.config import OptimizationConfig as JOpt
    from curve_gaussian_tpu.config import PipelineConfig as JPipe
    from curve_gaussian_tpu.engine import train as jtrain
    from curve_gaussian_tpu.parallel import sharding as jps
    from test_torch_port_geometry import cam_pair, exact_sort, jax_state, jax_x64
    from test_torch_port_step import _numpy_ts
    from test_torch_port_views import _problem

    work = str(tmp_path_factory.mktemp("ranks4"))
    params, is_bez, alive, gts, jcams, _ = _problem()
    with jax_x64():
        s0 = _numpy_ts(jtrain.init_train_state(jax_state(params, is_bez, alive)))
    H, W = RENDER_HW
    rc = [cam_pair(e, [0, 0, 0], H, W, dtype=np.float32)[0]
          for e in ([0.0, -0.3, -1.2], [0.4, -0.2, -1.3])]
    geom = (gts.shape[1], gts.shape[2], float(jcams[0].tanfovx), float(jcams[0].tanfovy))
    inp = dict(s0=s0, gts=gts, H=gts.shape[1], W=gts.shape[2], tan=geom[2:], geom=geom,
               cams=[tuple(np.asarray(a, np.float64) for a in
                           (c.world_to_cam, c.full_proj, c.cam_center)) for c in jcams],
               render_cams=[tuple(np.asarray(a) for a in
                                  (c.world_to_cam, c.full_proj, c.cam_center)) for c in rc],
               render_tan=(float(rc[0].tanfovx), float(rc[0].tanfovy)))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)

    env = {k: v for k, v in os.environ.items()
           if k not in ("CGT_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, os.path.abspath(__file__), str(r), work] for r in range(RANKS)]
    done = {}
    t = threading.Thread(target=lambda: done.update(
        res=pmh.run_ranks(cmds, TIMEOUT_S, env=env, cwd=ROOT)))
    t.start()
    try:
        with jax_x64(), exact_sort():
            jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
            jts, jm = jps.parallel_train_step(
                jts, jps.camera_batch_arrays([jcams[v] for v in VIEWS]),
                jnp.asarray(gts[VIEWS]), jnp.zeros(()), JOpt(),
                JPipe(backend="reference", tile_capacity=TILE_K), use_mask=True,
                mesh_shape=(("data", RANKS),), cam_geom=geom, conn_on=True,
                view_indices=jnp.asarray(VIEWS, jnp.int32), use_exposure=True)
            ref = (_jax_state_leaves(jts), {k: np.array(v) for k, v in jm.items()})
    finally:
        t.join(TIMEOUT_S + 30)
    assert not t.is_alive(), "the ranks' launcher did not return"
    bad = pmh.failures(done["res"])
    assert not bad, bad
    out = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out, ref


def test_four_rank_step_matches_jax(ranks):
    """(a): every rank's step against the JAX step over a 4-device mesh."""
    from test_torch_port_step import F64_TOL

    out, ref = ranks
    for r in out:
        _assert_close(r["step"], ref, F64_TOL)
        _assert_equal(r["step"], out[0]["step"])
    assert out[0]["step"][0]["step"] == 1


def test_fused_body_equals_staged_four_ranks(ranks):
    """(b): the fused step body against the staged one, over a chunk of 3
    steps with 2 active, on each rank; gloo picks the staged form."""
    out, _ = ranks
    for r in out:
        assert r["fuses"] == [False, False]
        _assert_equal(r["chunk_fused"], r["chunk_staged"])
        _assert_equal(r["chunk_fused"], out[0]["chunk_fused"])
        leaves, metrics = r["chunk_fused"]
        assert leaves["step"] == N_ACTIVE and all(v.shape == (3,) for v in metrics.values())


def test_fused_band_render_equals_staged(ranks):
    out, _ = ranks
    for r in out:
        assert len(r["renders_fused"]) == len(RENDER_VIEWS)
        for f, s, e in zip(r["renders_fused"], r["renders_staged"], r["render_each"]):
            assert f.shape == RENDER_HW and np.array_equal(f, s) and np.array_equal(f, e)
        for a, b in zip(r["renders_fused"], out[0]["renders_fused"]):
            assert np.array_equal(a, b)
    img = out[0]["renders_fused"][1]
    assert img[:32].max() > 0.05 and img[32:64].max() > 0.05  # the first two bands render


# ---------------------------------------------------------------------------
# (c) the predicate
# ---------------------------------------------------------------------------


def _group(monkeypatch, backend: str, ranks: int, cards: int, local=None):
    monkeypatch.setattr(pmh, "group_size", lambda: ranks)
    monkeypatch.setattr(pmh.dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))


def test_gloo_picks_the_staged_form(monkeypatch):
    _group(monkeypatch, "gloo", 4, 4)
    assert not pmh.captures_collectives()
    assert not ptrain.StepGraphs(pps.batch_step(4)).fuses()


def test_nccl_with_a_card_per_rank_picks_the_fused_form(monkeypatch):
    _group(monkeypatch, "nccl", 4, 4)
    assert pmh.captures_collectives()
    assert ptrain.StepGraphs(pps.batch_step(4)).fuses()
    assert not ptrain.StepGraphs(pps.batch_step(4), fused=False).fuses()
    assert not ptrain.StepGraphs().fuses()  # a one-device step has nothing to fuse
    _group(monkeypatch, "nccl", 4, 2, local=2)  # two hosts of two cards
    assert pmh.captures_collectives()


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    _group(monkeypatch, "nccl", 4, 2)
    with pytest.raises(RuntimeError, match="NCCL takes one card per rank: 4 ranks"):
        pmh.captures_collectives()
    with pytest.raises(RuntimeError, match="NCCL takes one card per rank"):
        ptrain.StepGraphs(pps.batch_step(4)).fuses()
    with pytest.raises(RuntimeError, match="NCCL takes one card per rank: 4 ranks"):
        pmh.initialize_distributed("tcp://localhost:1", 4, 0, backend="nccl")
    assert not dist.is_initialized()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2])
