"""Two checkouts of the repository in turns (other, this, this, other), on
the card, so that two commits compare on one card in one call.

    python -m curve_gaussian_tpu_torch.scripts.cell_turns --other <checkout>
    python -m curve_gaussian_tpu_torch.scripts.cell_turns --other <checkout> --kernels

By default: the driver cell and the dataset cell of ``chip_smoke.py``
(phases 9 and 10d), iterations per second over ``train_scene`` and host
seconds by phase of each run.  The dataset scene is made once, by this
checkout's scene maker at its defaults (1600², 50 views), under ``--out``.

With ``--kernels``: at ``chip_smoke.py``'s bench configuration (3,375 grid
seed curves in a capacity of 4,096 x 12 Gaussians, 4 ring views of 512²,
default configs), the blend backward kernels on view 0 (``cuda_ms``: K2
whole, and its moment kernel alone where the checkout has one; K5 and K6b
on the training step's inputs (``step_inputs``); K4 at (T, T, T) and
(F, F, T) on random cotangents (``tile_inputs``); the slot -> Gaussian
reduction where the checkout has it), then 20 steps of the step graph
(``train_steps_scan``) twice on the host clock and one replay's device
time, then the graphed eval render of the 4 views (``eval_renders``) twice
on the host clock, one replay's device time and its graph's nodes.

Each turn is a process of its own that runs this file with ``PYTHONPATH``
at its checkout, so it measures that checkout's package and builds that
checkout's kernels (into its own ``build/torch_kernels/``); the inputs and
the timer are this file's, through the API both checkouts share.  Each
turn prints one JSON line per cell, or one for the kernels; this script
prints them, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# chip_smoke.py's DRIVER_ARGS (without the checkpoint) and DATASET_ARGS
DRIVER_ARGS = ["--synthetic", "--image-size", "512", "--grid-init", "15", "--n-gaussians", "12",
               "--iterations", "600", "--test-iterations", "300", "600", "--seed", "0",
               "--quiet"]
DATASET_ARGS = ["-r", "2", "--eval", "--iterations", "600", "--test-iterations", "300", "600",
                "--seed", "0", "--quiet"]
STEPS = 20  # graphed steps a timing of the kernels' turn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="two checkouts in turns: the driver and dataset "
                                            "cells, or the blend backward kernels")
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--out", default="output_torch/cell_turns")
    p.add_argument("--kernels", action="store_true",
                   help="the blend backward kernels, the graphed step and the graphed eval "
                        "render instead of the cells")
    p.add_argument("--turn", default=None, help=argparse.SUPPRESS)  # a turn's own process
    return p.parse_args(argv)


def cuda_ms(fn, iters: int, setup=None) -> float:
    """Median device milliseconds of fn() (or fn(setup()), setup outside the
    timing) over `iters` calls, from CUDA events around each call.

    A spin kernel (~50 ms) is queued first, so the host enqueues the timed
    calls while the card is busy and its dispatch between launches stays out
    of the events, for calls whose host time is below that; the eager plain
    versions exceed it and include their dispatch."""
    import torch

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


def splat_inputs(xyz, scale, quat, opacity, cam, capacity, big_capacity, geo, invd, ones,
                 color=None, alive=None, **bin_kw):
    """(fields, binning) of one view of Gaussians for a channel set, as
    ``render`` builds them; `bin_kw` goes to ``bin_gaussians``."""
    import torch

    from curve_gaussian_tpu_torch.ops import rasterize_cuda as RC
    from curve_gaussian_tpu_torch.ops.binning import bin_gaussians
    from curve_gaussian_tpu_torch.ops.projection import preprocess
    from curve_gaussian_tpu_torch.ops.render import main_axis_allmap

    with torch.no_grad():
        pre = preprocess(xyz, scale, quat, opacity, cam, alive=alive)
        b = bin_gaussians(pre, cam.height, cam.width, capacity=capacity,
                          big_capacity=big_capacity, **bin_kw)
        color = torch.ones_like(pre.opacity) if color is None else color
        fields = RC.stack_fields(pre, color, main_axis_allmap(xyz, quat, cam),
                                 geo=geo, invd=invd, ones=ones).contiguous()
    return fields, b


def tile_inputs(state, cam, pipe_cfg, geo, invd, ones, color=None, **bin_kw):
    """(fields, binning) of one view of a state for a channel set."""
    import torch

    from curve_gaussian_tpu_torch.models import curve_state as cs

    with torch.no_grad():
        g = cs.gaussians(state)
    return splat_inputs(g["xyz"], g["scale"], g["quat"], g["opacity"], cam,
                        pipe_cfg.tile_capacity, pipe_cfg.big_capacity, geo, invd, ones, color,
                        alive=g["alive"], **bin_kw)


def step_inputs(state, cam, gt, pipe_cfg, **bin_kw):
    """The blend and SSIM inputs of one training step of `state` at view
    `cam` against `gt`: (fields, binning, render, final T, colour and T
    cotangents), the cotangent the image loss's gradient at this render;
    `bin_kw` goes to ``bin_gaussians``."""
    import torch

    from curve_gaussian_tpu_torch.models import curve_state as cs
    from curve_gaussian_tpu_torch.models import losses as L
    from curve_gaussian_tpu_torch.ops import rasterize_cuda as RC
    from curve_gaussian_tpu_torch.ops import ssim_cuda as SC
    from curve_gaussian_tpu_torch.ops.binning import bin_gaussians
    from curve_gaussian_tpu_torch.ops.projection import preprocess

    H, W = cam.height, cam.width
    with torch.no_grad():
        g = cs.gaussians(state)
        pre = preprocess(g["xyz"], g["scale"], g["quat"], g["opacity"], cam, alive=g["alive"])
        b = bin_gaussians(pre, H, W, capacity=pipe_cfg.tile_capacity,
                          big_capacity=pipe_cfg.big_capacity, **bin_kw)
        fields = RC.stack_fields(pre).contiguous()
        col, finT = RC.blend_train_fwd(fields, b.gather_idx, b.counts,
                                       torch.zeros(1, device=fields.device), H, W)
    img = col.clone().requires_grad_(True)
    with torch.enable_grad():
        lo = L.edge_aware_loss(img, gt) + (1.0 - SC.ssim_fused(img, gt))
        (gc,) = torch.autograd.grad(lo, img)
    gc = gc.contiguous()
    gen = torch.Generator(fields.device).manual_seed(0)
    gtt = (torch.randn(H, W, device=fields.device, generator=gen) * gc.abs().max()).contiguous()
    return fields, b, col, finT, gc, gtt


def run_cells(out: str, scene: str, tag: str) -> None:
    """Both cells through the ``train`` of the checkout on ``sys.path``;
    prints one JSON line per cell."""
    import torch

    from curve_gaussian_tpu_torch import train as TR

    for cell, argv in (("driver", DRIVER_ARGS), ("dataset", ["-s", scene] + DATASET_ARGS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = TR.main(argv + ["--model-path", os.path.join(out, f"{tag}_{cell}")])
        sec, it = res.seconds, int(res.ts.step)
        print(json.dumps(dict(
            cell=cell, tree=tag, iterations=it, it_per_s=it / sec["train"],
            share={k: v / sec["train"] for k, v in sec.items() if k != "train"}, seconds=sec,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)


def run_kernels(tag: str) -> None:
    """The kernels, the graphed step and the graphed eval render of the
    checkout on ``sys.path``; prints one JSON line."""
    import numpy as np
    import torch

    from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
    from curve_gaussian_tpu_torch.data import synthetic
    from curve_gaussian_tpu_torch.engine import train as T
    from curve_gaussian_tpu_torch.engine.graph_nodes import graph_nodes
    from curve_gaussian_tpu_torch.models import curve_state as cs
    from curve_gaussian_tpu_torch.ops import rasterize_cuda as RC
    from curve_gaussian_tpu_torch.ops import tile_blend_cuda as TB
    from curve_gaussian_tpu_torch.ops.binning import bin_gaussians

    dev = torch.device("cuda")
    H = W = 512
    n_views, M = 4, 12
    cams = synthetic.ring_cameras(n_views, H, W, device=dev)
    rng = np.random.default_rng(0)
    gts = [torch.tensor(rng.uniform(size=(H, W)) ** 4, dtype=torch.float32, device=dev)
           for _ in range(n_views)]
    state = cs.init_state(synthetic.grid_seed_points(15), n_views=n_views, n_gaussians=M,
                          device=dev)
    opt_cfg, pipe_cfg = OptimizationConfig(), PipelineConfig()

    # a checkout with the fixed-order backward reduces through the binning's slots table
    fixed = "slots" in inspect.signature(bin_gaussians).parameters
    kw = {"slots": True} if fixed else {}
    fields, b, col, finT, gc, gtt = step_inputs(state, cams[0], gts[0], pipe_cfg, **kw)
    ins = (fields, b.gather_idx, b.counts, col, finT, gc, gtt)
    slots = (b.slots,) if fixed else ()
    ms = {
        "K2": cuda_ms(lambda: RC.blend_train_bwd(*ins, *slots), 20),
        "K5": cuda_ms(lambda: TB.blend_moment_bwd(*ins), 20),
        "K6b": cuda_ms(lambda: RC.blend_train_bwd_basis(*ins, *slots), 20),
    }
    if fixed:
        ms["K2 moments"] = cuda_ms(lambda: RC.moment_rows(*ins), 20)
        rows = RC.moment_rows(*ins)
        ms["reduce_slots"] = cuda_ms(lambda: RC.reduce_slots(rows, b.slots, fields.shape[0]), 50)
    gen = torch.Generator(dev).manual_seed(2)
    for geo, invd in ((True, True), (False, False)):
        f4, b4 = tile_inputs(state, cams[0], pipe_cfg, geo, invd, True)
        outs = TB.tile_blend_fwd(f4, b4.gather_idx, b4.counts, torch.zeros(1, device=dev), H, W,
                                 geo, invd, True)
        cots = tuple(torch.randn(s, device=dev, generator=gen)
                     for s in ((H, W), (H, W), (H, W), (4, H, W)))
        ms[f"K4 {'(T,T,T)' if geo else '(F,F,T)'}"] = cuda_ms(
            lambda: TB.tile_blend_bwd(f4, b4.gather_idx, b4.counts, outs, cots, geo, invd,
                                      True), 20)

    ts = T.init_train_state(state)
    stacks = T.camera_stacks(cams, torch.float32, dev)
    geom = (H, W, cams[0].tanfovx, cams[0].tanfovy)

    def host_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3

    graphs = T.StepGraphs()
    rows_ = [i % n_views for i in range(STEPS)]
    gt_stack = torch.stack(gts)

    def graphed(rows):
        return T.train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg,
                                  use_mask=False, n_gaussians=M, cam_geom=geom, rows=rows,
                                  graphs=graphs)

    graphed([0])  # the capture, outside the timing
    step_ms = [host_ms(lambda: graphed(rows_), STEPS) for _ in range(2)]
    g, bufs = graphs.latest_graph(), graphs._bufs
    step_replay = cuda_ms(lambda _: g.replay(), 20, setup=lambda: bufs.counter.zero_())
    step_nodes = graph_nodes(g)
    graphs.release()

    rg = T.RenderGraphs()
    views = list(range(n_views))

    def renders():
        return T.eval_renders(ts, stacks, geom, pipe_cfg, 0.0, views, graphs=rg)

    renders()  # the capture, outside the timing
    render_ms = [host_ms(renders, n_views) for _ in range(2)]
    r = rg.latest()
    render_replay = cuda_ms(lambda _: r.graph.replay(), 20, setup=lambda: r.bufs.counter.zero_())
    render_nodes = graph_nodes(r.graph)
    rg.release()
    print(json.dumps(dict(tree=tag, kernel_ms=ms, step_ms_host=step_ms,
                          step_ms_device=step_replay, step_nodes=step_nodes,
                          render_ms_host=render_ms, render_ms_device=render_replay,
                          render_nodes=render_nodes, device=torch.cuda.get_device_name(0))),
          flush=True)


def summarize(lines: list) -> None:
    """Each kernel's, the step's and the render's numbers per checkout."""
    by = {t: [r for r in lines if r["tree"] == t] for t in ("other", "this")}
    for key in sorted({k for r in lines for k in r["kernel_ms"]}):
        vals = {t: [r["kernel_ms"].get(key) for r in rs] for t, rs in by.items()}
        print(f"{key}: other {vals['other']} ms, this {vals['this']} ms", flush=True)
    for t, rs in by.items():
        print(f"graphed step {t}: host {[m for r in rs for m in r['step_ms_host']]} ms/step, "
              f"device {[r['step_ms_device'] for r in rs]} ms a replay, nodes "
              f"{rs[0]['step_nodes']}", flush=True)
        print(f"graphed eval render {t}: host {[m for r in rs for m in r['render_ms_host']]} "
              f"ms/view, device {[r['render_ms_device'] for r in rs]} ms a replay of the 4 "
              f"views, nodes {rs[0]['render_nodes']}",
              flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    out = os.path.abspath(args.out)  # the runs' processes start in their checkouts
    scene = os.path.join(out, "refscale")
    if args.turn:
        if args.kernels:
            run_kernels(args.turn)
        else:
            run_cells(out, scene, args.turn)
        return
    from . import make_ref_scale_scene as MK
    from .refscale_quality import smi_line

    if not args.kernels:
        MK.make_ref_scale_scene(["--out", scene], quiet=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    lines = []
    for turn, tag in enumerate(("other", "this", "this", "other")):
        env = dict(os.environ, PYTHONPATH=trees[tag])
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", args.other,
                            "--out", out, "--turn", tag if args.kernels else f"{tag}{turn}"]
                           + (["--kernels"] if args.kernels else []),
                           env=env, capture_output=True, text=True, cwd=trees[tag])
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                lines.append(json.loads(line))
        if r.returncode:
            sys.exit(f"the {tag} run failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    if args.kernels:
        summarize(lines)
    print(smi_line(), flush=True)


if __name__ == "__main__":
    main()
