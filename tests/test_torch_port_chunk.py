"""``engine/train.py::train_steps_scan`` on CPU tensors, the eager form of the
step body that the card captures as a CUDA graph: held bitwise against
``train_steps``, the eager loop of ``train_step`` calls, over the same views.

A tiny scene (a few dozen curves at capacity 256 or 512, 4 Gaussians each,
three ring views at 32x32) in float64 and float32; no JAX.  The body reads
the state, the view (from stacks of all views) and the learning-rate row
from its buffers and writes the state and the metric row back, so equality
here checks the stacks, the device-side indexing, the learning-rate and
bias-correction table and the buffer round trip.  The CUDA graph itself is
exercised by ``chip_smoke.py`` on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.models import surgery as psurg

H = W = 32
M = 4
PIPE = PipelineConfig(tile_capacity=128, big_capacity=64)
OPT = OptimizationConfig()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread leaves the cores to the suite's
    other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _scene(dtype, n_curves=40, seed=0):
    rng = np.random.default_rng(seed)
    cams = psyn.ring_cameras(3, H, W, dtype=dtype, device="cpu")
    gts = torch.tensor(rng.uniform(size=(3, H, W)) ** 4, dtype=dtype)
    pts = rng.uniform(0.3, 0.7, size=(n_curves, 3))
    ts = ptrain.init_train_state(pcs.init_state(pts, n_views=3, n_gaussians=M, dtype=dtype,
                                                device="cpu"))
    return cams, gts, ts


def _stacks(cams):
    return tuple(torch.stack([getattr(c, f) for c in cams])
                 for f in ("world_to_cam", "full_proj", "cam_center"))


def _geom(cams):
    return (cams[0].height, cams[0].width, cams[0].tanfovx, cams[0].tanfovy)


def _leaves(ts):
    return {k: v.clone() for k, v in ptrain._state_leaves(ts).items()}


def _assert_states_equal(a, b):
    la, lb = ptrain._state_leaves(a), ptrain._state_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
    assert (a.step, a.opt.count, a.opacity_frozen) == (b.step, b.opt.count, b.opacity_frozen)


def _scan_and_loop(ts, cams, gts, order, **kw):
    """(scan's state and metrics, the loop's state and metrics) over `order`."""
    use_exp = kw.get("use_exposure", False)
    sts, sm = ptrain.train_steps_scan(ts, _stacks(cams), gts, 0.0, OPT, PIPE, n_gaussians=M,
                                      cam_geom=_geom(cams), rows=order,
                                      view_indices=order if use_exp else None, **kw)
    lts, lm = ptrain.train_steps(ts, [cams[i] for i in order], [gts[i] for i in order], 0.0,
                                 OPT, PIPE, n_gaussians=M,
                                 view_indices=order if use_exp else None, **kw)
    return sts, sm, lts, lm


CASES = {  # dtype, exposure and frozen opacity, loss flags
    "float64": (torch.float64, False, dict(use_mask=False)),
    "float32": (torch.float32, False, dict(use_mask=False)),
    "float32-exposure-frozen-masked": (torch.float32, True,
                                       dict(use_mask=True, conn_on=True, use_exposure=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_equals_train_steps(case):
    """State, Adam moments, statistics and every per-step metric bitwise
    equal to the eager loop; the input state unchanged."""
    dtype, exp_frozen, kw = CASES[case]
    cams, gts, ts = _scene(dtype)
    if exp_frozen:
        expo = torch.tensor([[1.1, 0.03], [0.85, -0.02], [1.0, 0.01]], dtype=dtype)
        ts = dataclasses.replace(ts, params={**ts.params, "exposure": expo},
                                 opacity_frozen=True)
    before = _leaves(ts)
    order = [2, 0, 1, 0]
    sts, sm, lts, lm = _scan_and_loop(ts, cams, gts, order, **kw)
    _assert_states_equal(sts, lts)
    assert sts.step == ts.step + 4
    assert list(sm) == list(lm[0]) and all(v.shape == (4,) for v in sm.values())
    for i, m in enumerate(lm):
        for k, v in m.items():
            assert sm[k][i].item() == v.to(torch.float64).item(), (i, k)
    for k, v in ptrain._state_leaves(ts).items():
        assert torch.equal(v, before[k]), f"the input state's {k} changed"
    assert not torch.equal(sts.params["curve_points"], ts.params["curve_points"])
    if exp_frozen:
        assert torch.equal(sts.params["opacity_raw"], ts.params["opacity_raw"])
        assert not torch.equal(sts.params["exposure"][0], ts.params["exposure"][0])


def test_scan_n_active_leaves_padded_steps_unchanged():
    """Steps at or past n_active are no-ops on the state, as in the JAX
    package's padded scan (tests/test_scan_loop.py)."""
    cams, gts, ts = _scene(torch.float64)
    sts, sm = ptrain.train_steps_scan(ts, _stacks(cams), gts, 0.0, OPT, PIPE, use_mask=False,
                                      n_gaussians=M, cam_geom=_geom(cams), rows=[1, 2, 0, 1],
                                      n_active=2)
    lts, lm = ptrain.train_steps(ts, [cams[1], cams[2]], [gts[1], gts[2]], 0.0, OPT, PIPE,
                                 use_mask=False, n_gaussians=M)
    _assert_states_equal(sts, lts)
    assert sts.step == 2 and all(v.shape == (4,) for v in sm.values())
    for i in range(2):
        assert sm["total"][i].item() == lm[i]["total"].item()


def test_scan_second_chunk_at_a_new_capacity():
    """One StepGraphs carried through a chunk, a surgery that repacks the
    state at a smaller capacity, and a second chunk: each chunk equals the
    eager loop from the same state."""
    cams, gts, ts = _scene(torch.float32, n_curves=300, seed=1)
    assert ts.alive.shape[0] == 512
    graphs = ptrain.StepGraphs()
    kw = dict(use_mask=False, n_gaussians=M, cam_geom=_geom(cams), graphs=graphs)
    ts1, _ = ptrain.train_steps_scan(ts, _stacks(cams), gts, 0.0, OPT, PIPE, rows=[0, 1], **kw)
    lts1, _ = ptrain.train_steps(ts, cams[:2], gts[:2], 0.0, OPT, PIPE, use_mask=False,
                                 n_gaussians=M)
    _assert_states_equal(ts1, lts1)
    host = psurg.extract(ts1)
    pruned = psurg.repack(psurg.keep(host, np.arange(host.n) < 100), ts1)
    assert pruned.alive.shape[0] == 256 and int(pruned.alive.sum()) == 100
    ts2, m2 = ptrain.train_steps_scan(pruned, _stacks(cams), gts, 0.0, OPT, PIPE, rows=[2, 0],
                                      **kw)
    lts2, lm2 = ptrain.train_steps(pruned, [cams[2], cams[0]], [gts[2], gts[0]], 0.0, OPT,
                                   PIPE, use_mask=False, n_gaussians=M)
    _assert_states_equal(ts2, lts2)
    assert ts2.step == 4 and m2["total"][1].item() == lm2[1]["total"].item()
    assert graphs.captures == []  # nothing is captured on the CPU


def test_scan_rejects_bad_indices():
    cams, gts, ts = _scene(torch.float32, n_curves=4)
    kw = dict(use_mask=False, n_gaussians=M, cam_geom=_geom(cams))
    with pytest.raises(ValueError, match="rows"):
        ptrain.train_steps_scan(ts, _stacks(cams), gts, 0.0, OPT, PIPE, rows=[0, 3], **kw)
    with pytest.raises(ValueError, match="view_indices"):
        ptrain.train_steps_scan(ts, _stacks(cams), gts, 0.0, OPT, PIPE, rows=[0],
                                view_indices=[5], use_exposure=True, **kw)
