"""Parity of the port's whole training step with the JAX package's
``engine.train.train_step`` (blend and SSIM Pallas kernels in interpret
mode): two chained steps on two views, with the mask and connectivity terms
on so that every loss term is live.

Compared after each step: the loss and every aux term, the gradient of each
trainable group, the post-Adam parameters and Adam moments, and the
densification statistics.  The JAX step returns no gradients; its Adam
first moments carry them exactly (mu_1 = (1 - b1) g_1, mu_2 = b1 mu_1 +
(1 - b1) g_2), which in float64 recovers g to ~1e-15.

float64: each array within 1e-6 of its max |value|.  The JAX step keeps a
few float32 values even under x64: the SSIM window, the Bézier basis and
the Adam bias corrections, which the port shares, and the learning rates
and the zeros whose gradient is the screen-space statistic, which leave
~1e-7 in the parameters and the accumulated statistic.
float32: the port's float32 step against the same float64 reference, with
the tolerances stated at F32_TOL.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from curve_gaussian_tpu.config import OptimizationConfig as JOpt
from curve_gaussian_tpu.config import PipelineConfig as JPipe
from curve_gaussian_tpu.engine import train as jtrain

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.engine import optim as poptim
from curve_gaussian_tpu_torch.engine import train as ptrain
from test_torch_port_geometry import (assert_close, cam_pair, exact_sort, jax_state, jax_x64,
                                      rel_err, state_arrays, tt)

C, M, H, W = 8, 6, 64, 64
TILE_K = 136  # see test_torch_port_blend: 8-instance backward groups in JAX
F64_TOL = 1e-6
# float32 port against the float64 reference: float32 rounding of every
# intermediate (~6e-8 relative per operation) through the compositing chain
# and the moment sums (measured ~2e-6 on gradients and statistics, 1e-7 on
# parameters, 2e-6 on loss terms; no gate flips at this scene's pixels)
F32_TOL = {"loss": 1e-5, "grads": 1e-4, "params": 1e-6, "stats": 1e-4}
AUX = ("edge_l1", "ssim", "mask", "opacity_pen", "curve_smo", "width", "curve_conn", "total")
TELEMETRY = ("overflow", "tile_peak", "big_peak", "big_overflow", "n_visible")
GROUPS = ("curve_points", "opacity_raw", "width_raw", "mask_raw")


def _scene():
    rng = np.random.default_rng(0)
    params, is_bez, alive = state_arrays(rng, C, M, n_lines=2, n_dead=1)
    cp = params["curve_points"]
    cp[1, 0] = cp[0, 3] + 0.01  # endpoints within conn_dist_threshold
    cp[4, 3] = cp[2, 0] - 0.02
    params["mask_raw"][3, :2] = -7.0  # gated off by the hard mask
    gts = [(rng.uniform(size=(H, W)) ** 3) for _ in range(2)]
    eyes = ([0.0, 0.2, -1.8], [0.3, -0.1, -1.7])
    return params, is_bez, alive, gts, eyes


def _numpy_ts(ts):
    """The JAX TrainState's leaves as numpy (read before a donating call)."""
    return dict(
        params={k: np.array(v) for k, v in ts.params.items()},
        mu={k: np.array(v) for k, v in ts.opt.mu.items()},
        nu={k: np.array(v) for k, v in ts.opt.nu.items()},
        count=int(ts.opt.count), is_bezier=np.array(ts.is_bezier), alive=np.array(ts.alive),
        xyz_grad_accum=np.array(ts.xyz_grad_accum), denom=np.array(ts.denom),
        max_radii=np.array(ts.max_radii), step=int(ts.step),
        opacity_frozen=bool(ts.opacity_frozen),
    )


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


@pytest.fixture(scope="module")
def reference():
    """Two JAX train_steps in float64 (built once for the module)."""
    params, is_bez, alive, gts, eyes = _scene()
    ts = jtrain.init_train_state(jax_state(params, is_bez, alive))
    states, metrics = [_numpy_ts(ts)], []
    for i in range(2):
        jc, _ = cam_pair(eyes[i], [0, 0, 0], H, W)
        ts, m = jtrain.train_step(
            ts, jc, jnp.asarray(gts[i]), jnp.zeros(()), JOpt(),
            JPipe(tile_capacity=TILE_K), use_mask=True, n_gaussians=M, conn_on=True,
        )
        states.append(_numpy_ts(ts))
        metrics.append({k: np.array(v) for k, v in m.items()})
    grads = []
    for i in (1, 2):
        mu, mu0 = states[i]["mu"], states[i - 1]["mu"]
        grads.append({k: (mu[k] - poptim.B1 * mu0[k]) / (1 - poptim.B1) for k in GROUPS})
    return dict(states=states, metrics=metrics, grads=grads, gts=gts, eyes=eyes)


def _port_start(reference, dtype):
    """The reference's initial state as the port's, with the two views."""
    s0 = reference["states"][0]
    ts = convert.train_state_from_numpy(
        s0["params"], s0["mu"], s0["nu"], s0["count"], s0["is_bezier"], s0["alive"],
        s0["xyz_grad_accum"], s0["denom"], s0["max_radii"], s0["step"],
        s0["opacity_frozen"], device="cpu", dtype=dtype,
    )
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    cams = [cam_pair(e, [0, 0, 0], H, W, np_dt)[1] for e in reference["eyes"]]
    return ts, cams, [tt(g, dtype) for g in reference["gts"]]


CFG = (0.0, OptimizationConfig(), PipelineConfig(tile_capacity=TILE_K))
KW = dict(use_mask=True, n_gaussians=M, conn_on=True)


def _port_run(reference, dtype):
    """The port's two steps from the reference's initial state."""
    ts, cams, gts = _port_start(reference, dtype)
    out = []
    for cam, gt in zip(cams, gts):
        _, _, grads, _, _, _, _ = ptrain.step_grads(ts, cam, gt, *CFG, **KW)
        ts, m = ptrain.train_step(ts, cam, gt, *CFG, **KW)
        out.append((ts, m, grads))
    return out


@pytest.fixture(scope="module")
def port64(reference):
    return _port_run(reference, torch.float64)


@pytest.mark.parametrize("step", [0, 1])
def test_loss_aux_and_telemetry(reference, port64, step):
    _, m, _ = port64[step]
    ref = reference["metrics"][step]
    for k in AUX:
        assert k in m, k
        assert abs(float(m[k]) - float(ref[k])) <= F64_TOL * max(abs(float(ref[k])), 1e-12), k
    for k in TELEMETRY:
        assert int(m[k]) == int(ref[k]), k
    assert float(ref["curve_conn"]) > 0 and float(ref["mask"]) > 0 and float(ref["width"]) > 0


@pytest.mark.parametrize("step", [0, 1])
def test_group_gradients(reference, port64, step):
    _, _, grads = port64[step]
    assert set(grads) == set(GROUPS)  # features_dc and exposure are dead groups
    for k in GROUPS:
        assert_close(grads[k], reference["grads"][step][k], F64_TOL, f"d {k}")


@pytest.mark.parametrize("step", [0, 1])
def test_params_moments_and_statistics(reference, port64, step):
    ts, _, _ = port64[step]
    ref = reference["states"][step + 1]
    for k in ref["params"]:
        assert_close(ts.params[k], ref["params"][k], F64_TOL, f"param {k}")
        assert_close(ts.opt.mu[k], ref["mu"][k], F64_TOL, f"mu {k}")
        assert_close(ts.opt.nu[k], ref["nu"][k], F64_TOL, f"nu {k}")
    for k in ("xyz_grad_accum", "denom", "max_radii"):
        assert_close(getattr(ts, k), ref[k], F64_TOL, k)
    assert (ts.step, ts.opt.count) == (ref["step"], ref["count"])
    assert float(ts.xyz_grad_accum.max()) > 0


def test_float32_step(reference):
    """The port's float32 step against the float64 reference."""
    for step, (ts, m, grads) in enumerate(_port_run(reference, torch.float32)):
        ref_m = reference["metrics"][step]
        ref_s = reference["states"][step + 1]
        assert ts.params["curve_points"].dtype == torch.float32
        for k in AUX:
            assert abs(float(m[k]) - float(ref_m[k])) <= F32_TOL["loss"] * max(
                abs(float(ref_m[k])), 1e-3), k
        for k in GROUPS:
            assert_close(grads[k], reference["grads"][step][k], F32_TOL["grads"], f"d {k}")
            assert_close(ts.params[k], ref_s["params"][k], F32_TOL["params"], k)
        for k in ("xyz_grad_accum", "denom"):
            assert rel_err(getattr(ts, k), ref_s[k]) <= F32_TOL["stats"], k


def test_train_steps_loop(port64, reference):
    """train_steps (the plain loop in place of the JAX lax.scan chunk) is
    the chain of train_step calls."""
    ts, cams, gts = _port_start(reference, torch.float64)
    ts, metrics = ptrain.train_steps(ts, cams, gts, *CFG, **KW)
    assert len(metrics) == 2 and ts.step == 2
    for k, v in port64[1][0].params.items():
        assert torch.equal(ts.params[k], v), k
