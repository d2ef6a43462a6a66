"""The training driver: schedule, capacity policy, logging, test renders,
checkpoints, artifacts and extraction, as
``curve_gaussian_tpu/engine/loop.py::train_scene``.

The optimizer update comes first and the surgery after it, as in the JAX
package (the reference runs surgery between backward and step and so drops
that iteration's update of every re-registered tensor).

What ``train_scene`` does, and how the port does it:

- **Chunks** are the host-sync cadence.  ``chunk_plan`` cuts the run at
  every event (surgery, test, save, checkpoint, the mask and connectivity
  flips) and at most every ``scan_chunk`` steps.  Each chunk runs through
  ``train_steps_scan``, which takes its views from device stacks of all
  views (cameras, intrinsics and edge maps, built once per scene): on the
  card it replays one captured CUDA graph of the step per shape key, with
  no host work between the steps, and on the CPU it runs the same step
  body eagerly.  The host reads the chunk's metrics once (one transfer),
  then applies the overflow and big-tier grow policy, logs, and runs the
  surgery the schedule prescribes.  ``TrainResult.graphs`` records the
  captures (their seconds are the ``capture`` phase) and replays.
- **Capacity.** Surgery repacks the state at the power-of-two bucket of its
  curve count, growing or shrinking at once.  The adaptive tile capacity K
  and the big tier shrink toward their observed peaks at the chunk end too:
  the JAX package's TPU run switches once the smaller shapes' compile has
  warmed, and the port has nothing to compile.  The B-view step reports no
  ``big_peak`` (as in the JAX package), so on that path the big tier only
  grows.
- **Views and background** come from ``random.Random(seed)`` in the JAX
  package's order, so both packages visit the same views.
- **Views per step and devices.** With ``views_per_step = B > 1`` each
  chunk draws its ``k * B`` views as a [k, B] table and runs through
  ``parallel/sharding.py::parallel_train_steps_scan``: one optimizer step
  over the mean gradient of B views, captured whole as one graph on the
  card.  Over N devices, each a rank of a ``torch.distributed`` process
  group that runs this same function (``torchrun``, or
  ``parallel/multihost.py``), each rank takes its B/N columns of the table
  and the ranks exchange their sums every step (inside the step's graph
  over NCCL, eagerly over gloo on the CPU); every rank then holds the
  same state and runs the same surgery, capacity policy and chunk plan on
  the same reduced metrics.  N is the JAX rule's, ``min(n_devices, B,
  world)`` shrunk until it divides B, and it must be the group's size: the
  port raises where the JAX driver would quietly run fewer devices.  Only
  rank 0 writes (the log, test renders, artifacts, checkpoints, the
  extracted curves) and prints.
- **Profile.** With ``profile_dir`` the second chunk runs with device
  spans (``engine/spans.py``: device milliseconds a step by module, on
  every rank) and rank 0 profiles it and the loop's work after it:
  ``trace.json`` shows the host ranges ``chunk.*`` (``run_chunk``) and
  ``loop.readback``, ``loop.capacity``, ``loop.surgery.<op>``,
  ``loop.test_renders``, ``loop.save``; ``spans.json`` holds the spans
  and the chunk's stamps on the trace's clock, and over more than one rank
  every rank's ``exchange`` milliseconds (their spread is the imbalance
  between the ranks) and the bytes a step exchanges.
  ``TrainResult.span_ms`` carries the spans, and each surgery event its
  host seconds by op.
- **Left out as TPU/XLA machinery:** the ``Prewarmer`` and ``engine/warm.py``
  (ahead-of-time compiles), the persistent compile cache, the
  ``device_put`` commits of the state, the padding of every chunk to one
  compiled length (a graph replays any number of steps), and the deferral
  of a capacity shrink until its compile is warm (a capture takes about a
  step's time).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..data.ply import write_ply
from ..data.png import write_png
from ..eval import extract as extract_mod
from ..models import curve_state as cs
from ..models import surgery
from ..models.ellipsoids import save_ellipsoid_mesh
from ..models.gaussian_ply import save_gaussian_ply
from ..ops.camera import Camera
from ..parallel.multihost import check_ranks, group_size
from ..parallel.sharding import batch_step, make_mesh, parallel_train_steps_scan
from . import checkpoint as ckpt_mod
from . import spans
from .train import (RenderGraphs, StepGraphs, TrainState, camera_stacks, eval_renders,
                    init_train_state, train_step, train_steps_scan)


class JsonlLogger:
    """Metrics logger: one JSON row per logged iteration in
    <model_path>/metrics.jsonl, and a progress line on stdout."""

    def __init__(self, model_path: str, quiet: bool = False, write: bool = True):
        self.path = os.path.join(model_path, "metrics.jsonl")
        self.f = None
        if write:  # a rank other than 0 keeps the averages only
            os.makedirs(model_path, exist_ok=True)
            self.f = open(self.path, "a")
        self.quiet = quiet
        self.ema: Dict[str, float] = {}

    def log(self, iteration: int, metrics: Dict[str, float], extra=None):
        row = {"iter": iteration, **{k: float(v) for k, v in metrics.items()}}
        if extra:
            row.update(extra)
        if self.f is not None:
            self.f.write(json.dumps(row) + "\n")
            self.f.flush()  # rows must be visible while the run is live
        for k, v in metrics.items():
            self.ema[k] = 0.4 * float(v) + 0.6 * self.ema.get(k, float(v))

    def progress(self, iteration: int, n_curves: int):
        if self.quiet:
            return
        ema = self.ema
        print(
            f"[{iteration:6d}] loss {ema.get('total', 0):.5f} "
            f"smo {ema.get('curve_smo', 0):.5f} "
            f"conn {ema.get('curve_conn', 0):.5f} curves {n_curves}",
            flush=True,
        )

    def close(self):
        if self.f is not None:
            self.f.close()


class Chunk(NamedTuple):
    """`k` steps after iteration `start` between two host syncs, with the
    loss flags that hold for all of them.  `kp` is the JAX package's padded
    scan length (its compiled shape), kept for ``future_combos``."""

    start: int
    k: int
    kp: int
    use_mask: bool
    conn_on: bool


def build_events(
    first_iter: int,
    opt_cfg: OptimizationConfig,
    test_iterations: Sequence[int] = (),
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
) -> Set[int]:
    """Iterations after which the host acts: every surgery, the test, save
    and checkpoint iterations, the last one, and a boundary right before
    each loss-flag flip (the mask at densify_until, the connectivity term
    after conn_from_iter)."""
    events = set()
    for i in range(first_iter + 1, opt_cfg.iterations + 1):
        if surgery.schedule_fires(i, opt_cfg) or i == opt_cfg.densify_until_iter:
            events.add(i)
    events.add(opt_cfg.densify_until_iter - 1)
    events.add(opt_cfg.conn_from_iter)
    events.update(test_iterations)
    events.update(save_iterations)
    events.update(checkpoint_iterations)
    events.add(opt_cfg.iterations)
    return {e for e in events if first_iter < e <= opt_cfg.iterations}


def chunk_plan(first_iter: int, opt_cfg: OptimizationConfig, events: Set[int],
               scan_chunk: int) -> List[Chunk]:
    """The whole run's chunks, from the configuration alone: each ends at
    the next event or after `scan_chunk` steps."""
    plan: List[Chunk] = []
    it = first_iter
    while it < opt_cfg.iterations:
        nxt = min([e for e in events if e > it] or [opt_cfg.iterations])
        k = min(nxt - it, scan_chunk)
        kp = scan_chunk if k == scan_chunk else min(
            1 << (k - 1).bit_length() if k > 1 else 1, scan_chunk
        )
        plan.append(Chunk(it, k, kp, (it + 1) >= opt_cfg.densify_until_iter,
                          (it + 1) > opt_cfg.conn_from_iter))
        it += k
    return plan


def future_combos(plan: List[Chunk], from_iter: int) -> List[Tuple[int, bool, bool]]:
    """Distinct (kp, use_mask, conn_on) chunk shapes at or after
    `from_iter`, in order of first use."""
    out: List[Tuple[int, bool, bool]] = []
    for ch in plan:
        if ch.start < from_iter:
            continue
        key = (ch.kp, ch.use_mask, ch.conn_on)
        if key not in out:
            out.append(key)
    return out


def want_tile_capacity(peak: int, cur: int, floor: int = 128) -> int:
    """Adaptive capacity: 2x headroom over the observed peak, a power of
    two, never below `floor` (raised whenever a capacity overflowed), and
    only a cut of at least 25% (hysteresis)."""
    want = floor
    while want < 2 * peak:
        want *= 2
    want = min(want, cur)
    return want if want <= 3 * cur // 4 else cur


@dataclasses.dataclass
class TrainResult:
    ts: TrainState
    edge_dict: Dict
    metrics_path: str
    model_path: str
    pipe_cfg: Optional[PipelineConfig] = None  # final (the capacities may change)
    # what the driver did, in order: surgery (iteration, operations, curves,
    # capacity, host seconds, host seconds by operation) and tile/big
    # capacity changes
    events: List[dict] = dataclasses.field(default_factory=list)
    # host seconds by phase: steps (with their per-chunk metric reads),
    # capture (the step graphs' warm-up, capture and instantiation),
    # surgery, test renders, saves (artifacts and checkpoints), extraction
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the step graphs' captures and replays (released; no graph is held); over
    # more than one rank, the device ms a step (fused_step_ms)
    graphs: Optional[StepGraphs] = None
    # the test renders' graphs: their captures and replays (released too)
    render_graphs: Optional[RenderGraphs] = None
    # device milliseconds a step by span (engine/spans.py) over the chunks
    # that ran with device spans (the profiled chunk of ``profile_dir``)
    span_ms: Optional[Dict[str, float]] = None
    # over more than one rank: the bytes a step exchanges (its SUM and MAX
    # buffers, StepGraphs.exchange_bytes)
    exchange_bytes: Optional[int] = None


def _chunk_metrics(ms: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A chunk's per-step metrics ({name: [k]}) as {name: [k] float64},
    read from the device in one transfer."""
    host = torch.stack(list(ms.values()), dim=1).cpu().numpy()
    return {key: host[:, i] for i, key in enumerate(ms)}


def train_scene(
    cameras: Sequence[Camera],
    edge_maps: Sequence,
    seed_points: np.ndarray,
    model_cfg: ModelConfig,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    model_path: str,
    test_cameras: Sequence[Camera] = (),
    test_edge_maps: Sequence = (),
    test_iterations: Sequence[int] = (3000, 10000),
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    start_checkpoint: Optional[str] = None,
    log_every: int = 10,
    quiet: bool = False,
    seed: int = 0,
    scan_chunk: int = 100,
    dump_images: bool = True,
    views_per_step: int = 1,
    n_devices: Optional[int] = None,
    profile_dir: Optional[str] = None,
    device="cuda",
) -> TrainResult:
    """Train one scene end to end on `device`.  The cameras and edge maps
    (numpy or tensors) must be on that device or the host; the state is
    float32, as in the JAX package.  ``views_per_step`` views make one
    optimizer step (their mean gradient), split over ``n_devices`` ranks of
    the process group (every rank calls this function with the same
    arguments and its own device)."""
    B = max(int(views_per_step), 1)
    world = group_size()
    want = n_devices or world
    check_ranks(want)  # raises unless the group has n_devices ranks, saying what to launch
    # the JAX driver's rule: at most B and the devices there are, dividing B
    ndev = min(want, B)
    while B % ndev:
        ndev -= 1
    if ndev != world:
        raise RuntimeError(
            f"views_per_step={B} splits evenly over {ndev} device(s), not over the process "
            f"group's {world} ranks; give a multiple of {world} views per step or launch "
            f"{ndev} rank(s)")
    # the JAX driver's route: B views per step, or more than one device
    parallel = B > 1 or ndev > 1
    dev = resolve_device(device)
    mesh = make_mesh(ndev, device=dev)
    rank0 = mesh.rank == 0
    quiet = quiet or not rank0
    m = model_cfg.n_gaussians
    state = cs.init_state(seed_points, n_views=len(cameras), n_gaussians=m, device=dev)
    ts = init_train_state(state)
    first_iter = 0
    if start_checkpoint:
        cap, _ = ckpt_mod.checkpoint_capacity(start_checkpoint)
        if cap != state.capacity:
            # a template at the saved capacity; every leaf comes from the
            # file, so the first `cap` seeds stand in when surgery shrank the
            # state below the seed count (the JAX driver pads all the seeds
            # into the template and fails there)
            state = cs.init_state(np.asarray(seed_points)[:cap], n_views=len(cameras),
                                  n_gaussians=m, capacity=cap, device=dev)
            ts = init_train_state(state)
        ts = ckpt_mod.load_checkpoint(start_checkpoint, ts)
        first_iter = int(ts.step)

    bg = 1.0 if model_cfg.white_background else 0.0
    rng = random.Random(seed)
    if opt_cfg.random_background:
        bg = rng.random()

    if not all(c.height == cameras[0].height and c.width == cameras[0].width
               for c in cameras):
        raise ValueError(
            "train_scene requires uniform image sizes across views (the edge "
            "maps are stacked on the device); resize with -r or split the scene"
        )
    logger = JsonlLogger(model_path, quiet=quiet, write=rank0)
    if rank0:
        save_scene_artifacts(cameras, seed_points, model_path)
    dt = ts.params["curve_points"].dtype
    # device stacks of every view; each step selects its row on the device
    gt_all = torch.stack([torch.as_tensor(e) for e in edge_maps]).to(device=dev, dtype=dt)
    cam_stacks = camera_stacks(cameras, dt, dev)
    cam_geom = (cameras[0].height, cameras[0].width, cameras[0].tanfovx, cameras[0].tanfovy)
    graphs = StepGraphs(batch_step(ndev) if parallel else train_step)
    if parallel and not quiet:
        print(f"data-parallel: {B} views/step over {ndev} device(s)", flush=True)
    test_gts = [extract_mod.host_array(e) for e in test_edge_maps]
    test_groups = _view_groups(test_cameras, dt, dev)
    render_graphs = RenderGraphs()
    view_stack: List[int] = []
    t_start = time.time()
    seconds = dict(steps=0.0, capture=0.0, surgery=0.0, test_renders=0.0, saves=0.0,
                   extraction=0.0)
    events_log: List[dict] = []
    scan_chunk = max(1, min(scan_chunk, opt_cfg.iterations - first_iter))
    plan = chunk_plan(
        first_iter, opt_cfg,
        build_events(first_iter, opt_cfg, test_iterations, save_iterations,
                     checkpoint_iterations),
        scan_chunk,
    )
    # learned per-view exposure (the reference's train_test_exp): each step
    # applies its train view's row to the render inside the loss
    use_exp = model_cfg.train_test_exp

    k_floor = 128  # raised whenever a tile_capacity overflows
    b_floor = 256  # raised whenever the big tier overflows
    peak_window: List[int] = []
    bigpeak_window: List[int] = []

    def cap_event(iteration, kind, old, new, why):
        events_log.append(dict(iter=iteration, kind=kind, old=old, new=new, why=why))

    profiled = False
    for ch in plan:
        iteration, k = ch.start, ch.k
        use_mask, conn_on = ch.use_mask, ch.conn_on
        idxs = []
        for _ in range(k * B):
            if not view_stack:
                view_stack = list(range(len(cameras)))
            idxs.append(view_stack.pop(rng.randrange(len(view_stack))))
        t_chunk = time.time()
        # profile the second chunk (the first one pays the kernel builds) with
        # its device spans, on every rank (a capture of collectives takes them all)
        prof = None
        span_chunk = profile_dir is not None and iteration > first_iter and not profiled
        if span_chunk:
            profiled = True
            graphs.spans = True
            if rank0:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
        capture_s = graphs.capture_seconds
        if parallel:
            # this rank's columns of the chunk's [k, B] view table
            table = [mesh.block(idxs[j * B:(j + 1) * B]) for j in range(k)]
            ts, mt = parallel_train_steps_scan(
                ts, cam_stacks, gt_all, bg, opt_cfg, pipe_cfg, use_mask=use_mask,
                mesh_shape=mesh.shape, cam_geom=cam_geom, conn_on=conn_on,
                view_indices=table if use_exp else None, use_exposure=use_exp, rows=table,
                graphs=graphs,
            )
        else:
            ts, mt = train_steps_scan(
                ts, cam_stacks, gt_all, bg, opt_cfg, pipe_cfg, use_mask=use_mask,
                n_gaussians=m, cam_geom=cam_geom, conn_on=conn_on,
                view_indices=idxs if use_exp else None, use_exposure=use_exp, rows=idxs,
                graphs=graphs,
            )
        with spans.host("loop.readback"):
            metrics = _chunk_metrics(mt)  # the chunk's one host sync
        graphs.spans = False
        capture_s = graphs.capture_seconds - capture_s
        seconds["capture"] += capture_s
        seconds["steps"] += time.time() - t_chunk - capture_s

        with spans.host("loop.capacity"):
            ov = int(metrics["overflow"].sum())
            tol = pipe_cfg.overflow_tolerance * float(metrics["n_visible"].sum())
            peak_window.append(int(metrics["tile_peak"].max()))
            if "big_peak" in metrics:  # the B-view step has none (nor has the JAX one)
                bigpeak_window.append(int(metrics["big_peak"].max()))
            if 0 < ov <= tol:
                k_floor = max(k_floor, pipe_cfg.tile_capacity)
                print(
                    f"[{iteration + k:6d}] binning dropped {ov} tile candidates "
                    f"(within tolerance {tol:.0f}; occluded tail, not growing)",
                    flush=True,
                )
            elif ov > 0:
                print(
                    f"[{iteration + k:6d}] WARNING: binning dropped {ov} tile "
                    f"candidates this chunk (tile_capacity {pipe_cfg.tile_capacity}"
                    f", policy {pipe_cfg.overflow_policy})",
                    flush=True,
                )
                if pipe_cfg.overflow_policy == "raise":
                    raise RuntimeError(
                        f"tile binning overflow ({ov} candidates dropped at "
                        f"tile_capacity={pipe_cfg.tile_capacity}); raise "
                        "--tile-capacity or use overflow_policy='grow'"
                    )
                if (pipe_cfg.overflow_policy == "grow"
                        and pipe_cfg.tile_capacity < pipe_cfg.max_tile_capacity):
                    old = pipe_cfg.tile_capacity
                    pipe_cfg = dataclasses.replace(
                        pipe_cfg, tile_capacity=min(old * 2, pipe_cfg.max_tile_capacity))
                    k_floor = max(k_floor, pipe_cfg.tile_capacity)
                    cap_event(iteration + k, "tile_capacity", old, pipe_cfg.tile_capacity,
                              "grow")
                    print(f"[{iteration + k:6d}] growing tile_capacity -> "
                          f"{pipe_cfg.tile_capacity} (from the next chunk)", flush=True)
            # the big-rect tier grows on its own overflow count, so that the
            # right capacity grows
            bov = int(metrics["big_overflow"].sum())
            if bov > 0:
                print(
                    f"[{iteration + k:6d}] WARNING: big-rect tier dropped {bov} "
                    f"candidate slots (big_capacity {pipe_cfg.big_capacity})",
                    flush=True,
                )
                if (pipe_cfg.overflow_policy == "grow"
                        and pipe_cfg.big_capacity < pipe_cfg.max_big_capacity):
                    old = pipe_cfg.big_capacity
                    pipe_cfg = dataclasses.replace(
                        pipe_cfg, big_capacity=min(old * 2, pipe_cfg.max_big_capacity))
                    b_floor = max(b_floor, pipe_cfg.big_capacity)
                    cap_event(iteration + k, "big_capacity", old, pipe_cfg.big_capacity, "grow")
                    print(f"[{iteration + k:6d}] growing big_capacity -> "
                          f"{pipe_cfg.big_capacity} (from the next chunk)", flush=True)
        # per-iteration wall time (the reference's iter_time scalar)
        metrics["iter_time"] = np.full(k, (time.time() - t_chunk) / k, np.float32)
        for j in range(k):
            it_j = iteration + 1 + j
            if it_j % log_every == 0:
                logger.log(it_j, {kk: v[j] for kk, v in metrics.items()})
        iteration += k
        if iteration % (log_every * 50) < k:
            logger.progress(iteration, int(ts.alive.sum()))

        ops = surgery.fired_ops(iteration, opt_cfg)
        if ops:
            t0 = time.time()
            op_s: Dict[str, float] = {}
            ts = surgery.apply_schedule(
                ts, iteration, opt_cfg,
                span=lambda op: spans.host(f"loop.surgery.{op}", op_s, op))
            n_alive, cap = int(ts.alive.sum()), ts.alive.shape[0]
            dt_s = time.time() - t0
            seconds["surgery"] += dt_s
            events_log.append(dict(iter=iteration, kind="surgery", ops=ops, curves=n_alive,
                                   capacity=cap, seconds=dt_s, op_seconds=op_s))
            if not quiet:
                print(f"[{iteration:6d}] surgery -> {n_alive} curves (capacity {cap})",
                      flush=True)

        # adaptive tile capacity: shrink the K and big-tier tables toward
        # the observed peaks (2x headroom, power of two, hysteresis)
        with spans.host("loop.capacity"):
            if peak_window and iteration < opt_cfg.iterations:
                want = want_tile_capacity(max(peak_window[-3:]), pipe_cfg.tile_capacity,
                                          k_floor)
                want_b = pipe_cfg.big_capacity
                if bigpeak_window:
                    want_b = want_tile_capacity(max(bigpeak_window[-3:]),
                                                pipe_cfg.big_capacity, b_floor)
                if want < pipe_cfg.tile_capacity or want_b < pipe_cfg.big_capacity:
                    pk = max(peak_window[-3:])
                    if want < pipe_cfg.tile_capacity:
                        cap_event(iteration, "tile_capacity", pipe_cfg.tile_capacity, want,
                                  "shrink")
                    if want_b < pipe_cfg.big_capacity:
                        cap_event(iteration, "big_capacity", pipe_cfg.big_capacity, want_b,
                                  "shrink")
                    pipe_cfg = dataclasses.replace(pipe_cfg, tile_capacity=want,
                                                   big_capacity=want_b)
                    peak_window.clear()
                    bigpeak_window.clear()
                    if not quiet:
                        print(f"[{iteration:6d}] shrinking tile_capacity -> {want} / "
                              f"big_capacity -> {want_b} (observed peaks {pk})", flush=True)

        if iteration in test_iterations and test_cameras and rank0:
            with spans.host("loop.test_renders", seconds, "test_renders"):
                l1s, psnrs = [], []
                # each geometry's views in one call; its stack reaches the host in one copy
                imgs, maps = [None] * len(test_cameras), {}
                for idx, stacks, geom in test_groups:
                    stack, full = eval_renders(
                        ts, stacks, geom, pipe_cfg, bg, range(len(idx)), use_mask=use_mask,
                        mask_threshold=opt_cfg.mask_threshold, graphs=render_graphs,
                        full=[j for j, ti in enumerate(idx) if dump_images and ti < 5])
                    host = stack.cpu().numpy()
                    for j, ti in enumerate(idx):
                        imgs[ti] = host[j]
                        if j in full:
                            maps[ti] = full[j]
                for ti, (img, tg) in enumerate(zip(imgs, test_gts)):
                    l1s.append(float(np.abs(img - tg).mean()))
                    psnrs.append(-10.0 * np.log10(float(np.mean((img - tg) ** 2)) + 1e-12))
                    if ti in maps:
                        save_debug_images(maps[ti], tg, model_path, iteration, ti)
            logger.log(iteration, {"test_l1": np.mean(l1s), "test_psnr": np.mean(psnrs)})
            if not quiet:
                print(f"[{iteration:6d}] test L1 {np.mean(l1s):.5f} "
                      f"PSNR {np.mean(psnrs):.2f}", flush=True)

        with spans.host("loop.save", seconds, "saves"):
            if iteration in save_iterations and rank0:
                save_model_artifacts(ts, model_path, iteration)
            if iteration in checkpoint_iterations and rank0:
                ckpt_mod.save_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.npz"), ts)
        # every rank's exchange span of the profiled chunk, gathered on every rank
        by_rank = exchange_ms_by_rank(graphs, ndev) if span_chunk and ndev > 1 else None
        if prof is not None:  # the profile ends with the chunk's iteration of this loop
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, "trace.json")
            prof.export_chrome_trace(trace)
            write_spans(graphs, trace, os.path.join(profile_dir, "spans.json"), by_rank)
            if not quiet:
                print(f"profiler trace -> {profile_dir}", flush=True)

    graphs.release()
    render_graphs.release()
    span_ms = graphs.span_ms() or None
    wall = time.time() - t_start
    done = int(ts.step) - first_iter
    if not quiet and done:
        print(f"training done: {done} iters in {wall:.1f}s ({done / wall:.2f} it/s)",
              flush=True)
        if graphs.fused_steps:
            print(f"fused multi-rank steps: {graphs.fused_step_ms:.3f} ms device per step over "
                  f"{graphs.fused_steps}", flush=True)
        if span_ms:
            print("device spans: " + ", ".join(f"{k} {v:.3f}" for k, v in span_ms.items())
                  + f" ms per step over {graphs.span_totals.steps}", flush=True)

    t0 = time.time()
    host = surgery.extract(ts)
    edge_dict = extract_mod.curves_to_edge_dict(
        host, merge_endpoints_flag=opt_cfg.merge_endpoints_flag)
    if opt_cfg.visible_checking:
        edge_dict = extract_mod.filter_visible_edges(edge_dict, cameras, edge_maps)
    if rank0:
        extract_mod.save_parametric_edges(edge_dict, model_path)
        pts, _ = extract_mod.sample_edge_dict(edge_dict)
        if len(pts):
            extract_mod.save_edge_points_ply(pts, model_path)
    logger.close()
    seconds["extraction"] = time.time() - t0
    seconds["train"] = wall
    return TrainResult(ts=ts, edge_dict=edge_dict, metrics_path=logger.path,
                       model_path=model_path, pipe_cfg=pipe_cfg, events=events_log,
                       seconds=seconds, graphs=graphs, render_graphs=render_graphs,
                       span_ms=span_ms, exchange_bytes=graphs.exchange_bytes)


def exchange_ms_by_rank(graphs: StepGraphs, n: int) -> List[Optional[float]]:
    """Each of the `n` ranks' ``exchange`` milliseconds a step over its
    chunks with device spans (a collective: every rank calls it)."""
    out: List[Optional[float]] = [None] * n
    dist.all_gather_object(out, graphs.span_ms().get(spans.EXCHANGE))
    return out


def write_spans(graphs: StepGraphs, trace: str, path: str,
                exchange_by_rank: Optional[List[Optional[float]]] = None) -> None:
    """``spans.json`` beside a profiler trace of a chunk with device spans:
    milliseconds a step by span, the chunk's steps, and its stamps on the
    trace's clock (``spans.anchored``); over more than one rank, each
    rank's ``exchange`` milliseconds (`exchange_by_rank`), their spread
    (the most less the least: the imbalance between the ranks) and the
    bytes a step exchanges."""
    span_ms = graphs.span_ms()  # sums the chunk's stamps first
    names, table = graphs.last_stamps
    out = dict(span_ms=span_ms, steps=table.shape[0])
    if exchange_by_rank is not None:
        got = [v for v in exchange_by_rank if v is not None]
        out.update(exchange_ms_by_rank=exchange_by_rank,
                   exchange_spread_ms=max(got) - min(got) if got else None,
                   exchange_bytes=graphs.exchange_bytes)
    with open(path, "w") as f:
        json.dump(dict(out, **spans.anchored(trace, names, table)), f, indent=1)


def _view_groups(cameras: Sequence[Camera], dtype, device) -> List[tuple]:
    """The views of `cameras` by image size, in order of first appearance:
    [(their indices, their ``camera_stacks`` on `device`, the first one's
    (H, W, tanfovx, tanfovy))], one ``eval_renders`` call each."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, c in enumerate(cameras):
        groups.setdefault((c.height, c.width), []).append(i)
    out = []
    for idx in groups.values():
        c = cameras[idx[0]]
        out.append((idx, camera_stacks([cameras[i] for i in idx], dtype, device),
                    (c.height, c.width, c.tanfovx, c.tanfovy)))
    return out


def _colormap_turbo(x: np.ndarray) -> np.ndarray:
    """[H,W] in [0,1] -> [H,W,3] uint8 through a compact turbo-like
    polynomial."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.61 * x**3 - 0.64 * x**2 + 0.82 * x + 0.19, 0, 1)
    g = np.clip(-3.2 * (x - 0.52) ** 2 + 0.92, 0, 1)
    b = np.clip(2.55 * (1 - x) ** 3 - 0.3 * (1 - x) + 0.27, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_debug_images(out, gt, model_path: str, iteration: int, view: int):
    """PNGs of the render, ground truth, alpha, inverse depth (colour-mapped)
    and direction map of one test view, under the JAX package's names."""
    d = os.path.join(model_path, f"test_images/iter_{iteration:06d}")
    os.makedirs(d, exist_ok=True)
    name = lambda s: os.path.join(d, f"v{view:02d}_{s}.png")  # noqa: E731

    def gray(s, a):
        write_png(name(s), (np.clip(extract_mod.host_array(a).astype(np.float32), 0, 1) * 255)
                  .astype(np.uint8))

    gray("render", out["render"])
    gray("gt", gt)
    gray("alpha", out["alpha"])
    invd = extract_mod.host_array(out["invdepth"]).astype(np.float32)
    rng = invd.max() - invd.min()
    write_png(name("depth"), _colormap_turbo((invd - invd.min()) / (rng if rng > 0 else 1.0)))
    # direction map: [-1,1]^3 -> RGB
    dir_img = np.moveaxis(extract_mod.host_array(out["dir"]).astype(np.float32), 0, -1)
    write_png(name("dir"), (np.clip(dir_img * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8))


def save_scene_artifacts(cameras, seed_points, model_path: str):
    """input.ply (the seed cloud) and cameras.json."""
    os.makedirs(model_path, exist_ok=True)
    write_ply(os.path.join(model_path, "input.ply"), np.asarray(seed_points))
    entries = []
    for i, cam in enumerate(cameras):
        c2w = np.linalg.inv(extract_mod.host_array(cam.world_to_cam).astype(np.float64))
        entries.append({
            "id": i,
            "img_name": f"{i:05d}",
            "width": cam.width,
            "height": cam.height,
            "position": c2w[:3, 3].tolist(),
            "rotation": [r.tolist() for r in c2w[:3, :3]],
            "fx": cam.width / (2.0 * cam.tanfovx),
            "fy": cam.height / (2.0 * cam.tanfovy),
        })
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(entries, f)


def save_model_artifacts(ts: TrainState, model_path: str, iteration: int):
    """Snapshots under point_cloud/iteration_<n>/: the curves as a point
    cloud, the Gaussians as a cloud with tangent normals, an ellipsoid mesh
    and a 3DGS-format PLY; and exposure.json.  The Gaussians are derived on
    the host from one copy of the alive curves."""
    out_dir = os.path.join(model_path, f"point_cloud/iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    host = surgery.extract(ts)
    if host.n == 0:
        return
    t = np.linspace(0, 1, 200)
    pts = surgery.np_curve_points(host.params["curve_points"], t, host.is_bezier).reshape(-1, 3)
    colors = np.random.default_rng(0).uniform(0.2, 1.0, size=(host.n, 3))
    write_ply(os.path.join(out_dir, f"curve_step{iteration}.ply"), pts,
              np.repeat(colors, len(t), axis=0))

    exposure = ts.params["exposure"].detach().cpu()
    state = cs.CurveState(
        **{k: torch.as_tensor(v) for k, v in host.params.items()},
        exposure=exposure,
        is_bezier=torch.as_tensor(host.is_bezier),
        alive=torch.ones((host.n,), dtype=torch.bool),
    )
    with torch.no_grad():
        g = {k: v.numpy() for k, v in cs.gaussians(state).items()}
    write_ply(os.path.join(out_dir, "gaussians.ply"), g["xyz"], normals=g["tangent"])
    save_ellipsoid_mesh(
        os.path.join(out_dir, f"ellipsoids_step{iteration}.ply"), g["xyz"], g["quat"],
        g["scale"], host.is_bezier, 1.0 / (1.0 + np.exp(-host.params["mask_raw"])),
    )
    save_gaussian_ply(os.path.join(out_dir, "point_cloud.ply"), g["xyz"], g["opacity"],
                      g["scale"], g["quat"])
    exposure = exposure.numpy()
    with open(os.path.join(model_path, "exposure.json"), "w") as f:
        json.dump({str(i): exposure[i].tolist() for i in range(len(exposure))}, f)
