#!/usr/bin/env python3
"""Drive the PyTorch port of CurveGaussian on one CUDA card.

    python3 chip_smoke.py            # build, check, train; needs one GPU
    python3 chip_smoke.py --profile  # also print a torch.profiler table of one step

1. Prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions.
2. Builds every kernel under ``curve_gaussian_tpu_torch/csrc/`` (one nvcc
   per source, all at once) into ``build/torch_kernels/``.
3. Holds each kernel of the training path against its plain PyTorch
   version on the card, at the shapes the main path gives it, and times
   both (CUDA events, median), beside the least time the card could take
   (``bound_ms``) and, for SSIM, a cuDNN conv2d SSIM (``library_ms``, never
   called by the port).
4. Checks one whole training step on the card against the same step on
   the CPU (plain versions) on a small scene.
5. Runs the main path at the bench configuration of the JAX package:
   3,375 grid seed curves in a capacity of 4,096 x 12 Gaussians, 4 ring
   views at 512x512, default configs: 5 warm-up steps, 20 timed steps, then
   2 steps with the mask and connectivity terms on.  Every kernel's launch
   counter must rise during that run, and the loss and gradients must stay
   finite.

Any failed check exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from curve_gaussian_tpu_torch import _build
from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic
from curve_gaussian_tpu_torch.engine import train as T
from curve_gaussian_tpu_torch.models import curve_state as cs
from curve_gaussian_tpu_torch.models import losses as L
from curve_gaussian_tpu_torch.ops import rasterize_cuda as RC
from curve_gaussian_tpu_torch.ops import ssim_cuda as SC
from curve_gaussian_tpu_torch.ops.binning import bin_gaussians
from curve_gaussian_tpu_torch.ops.projection import preprocess

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# float operations per (instance, pixel) of the blend kernels and per pixel
# of the SSIM kernels, counted from the kernels' source
K1_OPS = 19  # offsets 2, power 9, exp 1, alpha 2, gates 2, transmittance 3
K2_OPS = 45  # K1's 19, prefix 2, 1/(1-a) 2, g_alpha 4, moments 12, reduction 6
K7_OPS = 239  # products 3, two 11-tap passes over 5 maps 220, SSIM map 16
K8_OPS = 437  # moments 223, d-maps 30, adjoint blur of 4 maps 176, combine 8

# tolerances of kernel against plain version (max error over max |plain|)
TOL = {
    # same float32 operations in the same order (-fmad=false, expf): only a
    # gate flip at a threshold could move a pixel
    "blend_train_fwd": 1e-5,
    # float32 sums in another order (warp tree + atomicAdd vs torch.sum +
    # index_add_) over up to ~1e5 terms per Gaussian
    "blend_train_bwd": 1e-4,
    "ssim_fwd": 1e-5,  # absolute, on the value, as tests/test_ssim.py
    "ssim_bwd": 1e-4,  # tap sums in one order, the partial sums in another
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, setup=None) -> float:
    """Median device milliseconds of fn() (or fn(setup()), setup outside the
    timing) over `iters` calls, from CUDA events around each call.

    A spin kernel (~50 ms) is queued first, so the host enqueues the timed
    calls while the card is busy and its dispatch between launches stays out
    of the events, for calls whose host time is below that; the eager plain
    versions exceed it and include their dispatch."""
    args = (lambda: (setup(),)) if setup else (lambda: ())
    fn(*args())  # warm-up
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    evs = []
    for _ in range(iters):
        a = args()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*a)
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def bound_ms(nbytes: float, nops: float):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = nops / PEAK_F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    m = b.double().abs().max().item()
    return d / m if m > 0 else d


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc_v.stdout.strip().splitlines()[-1]}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- build -------------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack frame" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- bench configuration ---------------------------------------------------
    H = W = 512
    n_views, M = 4, 12
    cams = synthetic.ring_cameras(n_views, H, W, device=dev)
    rng = np.random.default_rng(0)
    gts = [torch.tensor(rng.uniform(size=(H, W)) ** 4, dtype=torch.float32, device=dev)
           for _ in range(n_views)]
    state = cs.init_state(synthetic.grid_seed_points(15), n_views=n_views, n_gaussians=M,
                          device=dev)
    opt_cfg, pipe_cfg = OptimizationConfig(), PipelineConfig()
    print(f"main path: {int(state.alive.sum())} curves in capacity {state.capacity}, "
          f"{state.capacity * M} Gaussians, {H}x{W}, {n_views} views", flush=True)

    # -- kernels against their plain versions, at the main path's shapes ------
    kernels = []
    with torch.no_grad():
        g = cs.gaussians(state)
        pre = preprocess(g["xyz"], g["scale"], g["quat"], g["opacity"], cams[0],
                         alive=g["alive"])
        binning = bin_gaussians(pre, H, W, capacity=pipe_cfg.tile_capacity,
                                big_capacity=pipe_cfg.big_capacity)
        fields = RC.stack_fields(pre).contiguous()
        gidx, counts = binning.gather_idx, binning.counts
        bg = torch.zeros(1, device=dev)
    n_inst = int(counts.sum())
    P1, Tn, K = fields.shape[0], gidx.shape[0], gidx.shape[1]
    print(f"blend inputs: P1={P1} T={Tn} K={K} instances={n_inst} "
          f"peak={int(binning.peak)}", flush=True)

    col, finT = RC.blend_train_fwd(fields, gidx, counts, bg, H, W)
    col_p, finT_p = RC.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    torch.cuda.synchronize()
    e1 = max(rel_err(col, col_p), rel_err(finT, finT_p))
    fb = P1 * 32 + n_inst * 4 + Tn * 4 + 4 + 2 * H * W * 4
    b1, by1 = bound_ms(fb, n_inst * 1024 * K1_OPS)
    kernels.append(dict(
        name="blend_train_fwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/blend_train.cu",
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:1180", launches=0, max_abs_err=
        max((col - col_p).abs().max().item(), (finT - finT_p).abs().max().item()),
        rel_err=e1,
        ms=cuda_ms(lambda: RC.blend_train_fwd(fields, gidx, counts, bg, H, W), 20),
        plain_ms=cuda_ms(lambda: RC.blend_train_fwd_plain(fields, gidx, counts, bg, H, W), 3),
        bound_ms=b1, bound_by=by1, library_ms=None,
    ))

    # a realistic colour cotangent: the image loss's gradient at this render
    img = col.clone().requires_grad_(True)
    with torch.enable_grad():
        lo = L.edge_aware_loss(img, gts[0]) + (1.0 - SC.ssim_fused(img, gts[0]))
        (gc,) = torch.autograd.grad(lo, img)
    gc = gc.contiguous()
    gtt = (torch.randn(H, W, device=dev, generator=torch.Generator(dev).manual_seed(0))
           * gc.abs().max()).contiguous()
    acc = RC.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt)
    acc_p = RC.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    torch.cuda.synchronize()
    e2 = rel_err(RC.moments_to_dfields(acc, fields), RC.moments_to_dfields(acc_p, fields))
    bb = P1 * 32 + n_inst * 4 + Tn * 4 + 4 * H * W * 4 + P1 * 32
    b2, by2 = bound_ms(bb, n_inst * 1024 * K2_OPS)
    kernels.append(dict(
        name="blend_train_bwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/blend_train.cu",
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:1310", launches=0,
        max_abs_err=(acc - acc_p).abs().max().item(), rel_err=e2,
        ms=cuda_ms(lambda: RC.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt), 20),
        plain_ms=cuda_ms(
            lambda: RC.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt), 3),
        bound_ms=b2, bound_by=by2, library_ms=None,
    ))

    # SSIM on the main path's pair: the render against its ground truth
    a, b = col.contiguous(), gts[0]
    win = torch.tensor(SC.gaussian_window(11), device=dev)
    win2 = (win[:, None] * win[None, :])[None, None]

    def conv_ssim(x, y):
        m = F.conv2d(torch.stack([x, y, x * x, y * y, x * y])[:, None], win2, padding=5)[:, 0]
        mu1, mu2, e11, e22, e12 = m
        return (((2 * mu1 * mu2 + SC.C1) * (2 * (e12 - mu1 * mu2) + SC.C2))
                / ((mu1 * mu1 + mu2 * mu2 + SC.C1) * (e11 - mu1 * mu1 + e22 - mu2 * mu2 + SC.C2))
                ).mean()

    v = SC.ssim_fwd(a, b)
    v_p = SC.ssim_fwd_plain(a, b)
    e7 = abs(v.item() - v_p.item())
    b7, by7 = bound_ms(2 * H * W * 4, H * W * K7_OPS)
    kernels.append(dict(
        name="ssim_fwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/ssim.cu",
        replaces="curve_gaussian_tpu/ops/ssim_pallas.py:98", launches=0, max_abs_err=e7,
        rel_err=e7, ms=cuda_ms(lambda: SC.ssim_fwd(a, b), 50),
        plain_ms=cuda_ms(lambda: SC.ssim_fwd_plain(a, b), 10),
        bound_ms=b7, bound_by=by7, library_ms=cuda_ms(lambda: conv_ssim(a, b), 50),
    ))
    gbar = torch.full((), -0.1, device=dev)
    d1, d2 = SC.ssim_bwd(a, b, gbar)
    d1p, d2p = SC.ssim_bwd_plain(a, b, gbar)
    torch.cuda.synchronize()
    e8 = max(rel_err(d1, d1p), rel_err(d2, d2p))
    b8, by8 = bound_ms(4 * H * W * 4, H * W * K8_OPS)
    ag = a.clone().requires_grad_(True)
    bgr = b.clone().requires_grad_(True)

    def conv_ssim_value():
        with torch.enable_grad():
            return conv_ssim(ag, bgr)

    kernels.append(dict(
        name="ssim_bwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/ssim.cu",
        replaces="curve_gaussian_tpu/ops/ssim_pallas.py:128", launches=0,
        max_abs_err=max((d1 - d1p).abs().max().item(), (d2 - d2p).abs().max().item()),
        rel_err=e8, ms=cuda_ms(lambda: SC.ssim_bwd(a, b, gbar), 50),
        plain_ms=cuda_ms(lambda: SC.ssim_bwd_plain(a, b, gbar), 10),
        bound_ms=b8, bound_by=by8,
        library_ms=cuda_ms(lambda v: torch.autograd.grad(v, (ag, bgr)), 50,
                           setup=conv_ssim_value),
    ))
    for k in kernels:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g} rel {k['rel_err']:.3g} "
              f"(tol {TOL[k['name']]:g}); {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library {k['library_ms']}",
              flush=True)
        if not (k["rel_err"] <= TOL[k["name"]]):
            fail(f"{k['name']} disagrees with its plain version: {k['rel_err']} > {TOL[k['name']]}")

    # -- one whole step on the card against the same step on the CPU ----------
    small_check()

    # -- the main path -----------------------------------------------------------
    wrappers = {"blend_train_fwd": RC.blend_train_fwd, "blend_train_bwd": RC.blend_train_bwd,
                "ssim_fwd": SC.ssim_fwd, "ssim_bwd": SC.ssim_bwd}
    ts = T.init_train_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    losses = []

    def step(i, use_mask=False, conn_on=None):
        nonlocal ts
        ts, m = T.train_step(ts, cams[i % n_views], gts[i % n_views], 0.0, opt_cfg, pipe_cfg,
                             use_mask=use_mask, n_gaussians=M, conn_on=conn_on)
        losses.append(m["total"])
        return m

    t0 = time.time()
    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    t0 = time.time()
    for i in range(20):
        m = step(5 + i)
    torch.cuda.synchronize()
    dt = time.time() - t0
    tele = {k: int(m[k]) for k in ("overflow", "tile_peak", "big_peak", "big_overflow")}
    steps_per_s = 20 / dt
    t0 = time.time()
    for i in range(2):
        m2 = step(25 + i, use_mask=True, conn_on=True)
    torch.cuda.synchronize()
    masked_s = (time.time() - t0) / 2
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    loss_v = torch.stack(losses).cpu()
    print(f"main path: 27 steps; losses first {loss_v[0]:.6f} last {loss_v[-1]:.6f}; "
          f"masked-step terms {sorted(m2)}", flush=True)
    print(f"main path: {steps_per_s:.3f} steps/s ({1e3 / steps_per_s:.3f} ms/step), "
          f"{steps_per_s * H * W / 1e6:.3f} Mpix/s fwd+bwd, warm-up 5 steps {warm_s:.2f} s, "
          f"mask+connectivity step {masked_s * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.3f} GiB, telemetry {tele}, launches {launches}", flush=True)
    if not bool(torch.isfinite(loss_v).all()):
        fail(f"non-finite loss in the main path: {loss_v.tolist()}")
    _, _, grads, goff, _, _, _ = T.step_grads(ts, cams[0], gts[0], 0.0, opt_cfg, pipe_cfg,
                                              use_mask=True, n_gaussians=M, conn_on=True)
    for name, t in list(grads.items()) + [("mean2d_offset", goff)] + list(ts.params.items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"non-finite values in {name} after the main path")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    if profile:
        profile_step(step)

    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "rel_err"}
                                  for d in kernels]}), flush=True)
    print(smi, flush=True)
    count = torch.cuda.device_count()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


def small_check():
    """One step_grads on the card and on the CPU, float32, small scene."""
    H = W = 96
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.2, 0.8, size=(24, 3)).astype(np.float32)
    gt = (rng.uniform(size=(H, W)) ** 4).astype(np.float32)
    out = {}
    for d in ("cpu", "cuda"):
        cams = synthetic.ring_cameras(1, H, W, device=d)
        st = cs.init_state(pts, n_views=1, n_gaussians=6, device=d)
        ts = T.init_train_state(st)
        out[d] = T.step_grads(ts, cams[0], torch.tensor(gt, device=d), 0.0, OptimizationConfig(),
                              PipelineConfig(tile_capacity=256, big_capacity=64), use_mask=True,
                              n_gaussians=6, conn_on=True)
    lc, lg = float(out["cpu"][0]), float(out["cuda"][0])
    errs = {k: (out["cuda"][2][k].cpu().double() - v.double()).abs().max().item()
            / max(v.double().abs().max().item(), 1e-30) for k, v in out["cpu"][2].items()}
    print(f"small step, card vs CPU: loss {lg:.8f} vs {lc:.8f}; grad errors over max {errs}",
          flush=True)
    # float32 on both sides; a pixel whose alpha or transmittance gate
    # flips between the two libm exps moves its gradients by up to ~1%
    if not (abs(lg - lc) <= 1e-5 * abs(lc) and max(errs.values()) <= 1e-2):
        fail("the training step on the card disagrees with the CPU step")


def profile_step(step):
    """Time by CUDA kernel over two steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            step(i)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    print(avg.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    # kernel rows only: an operator's row repeats the time of the kernels it launched
    kern = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"profile: device busy {busy_us / 2e3:.3f} ms per step over {len(kern)} kernel "
          f"names, {sum(e.count for e in kern) / 2:.0f} launches per step", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 2e3:8.4f} ms/step {e.count / 2:6.0f}x  "
              f"{e.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
