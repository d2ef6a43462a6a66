"""The multi-device dry run, the counterpart of the repository's
``__graft_entry__.py::dryrun_multichip``: every stage of the training
driver's cycle on a tiny problem over the N ranks of a process group.

    python -m curve_gaussian_tpu_torch.parallel.dryrun --n 2 --device cpu
    python -m curve_gaussian_tpu_torch.parallel.dryrun --n 4 --device cuda

Run as above, the script starts the N ranks itself (``multihost.run_ranks``,
a ``file://`` rendezvous in a temporary directory), waits for them at most
``--timeout`` seconds and exits non-zero if any rank fails or outlives it.
Each rank runs ``dryrun_multichip(N)``: one step, a chunk, the surgery of
``densify_until_iter``, extraction and repacking at a smaller capacity and
one more chunk, a checkpoint round trip (bitwise), one step from the
restored state and the tile-parallel render; rank 0 prints one line naming
the stages.  ``--device cuda`` puts rank r on ``cuda:r`` over NCCL, one
card per rank, and the chunks and the render run through the captured
graphs with their collectives inside; it raises with fewer cards than
ranks.  ``--device cpu`` runs the same bodies eagerly over gloo.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import OptimizationConfig, PipelineConfig
from ..data import synthetic
from ..engine import checkpoint as ckpt_mod
from ..engine.train import _state_leaves, camera_stacks, init_train_state
from ..models import curve_state as cs
from ..models import surgery
from . import multihost
from . import sharding as ps


def _tiny_problem(n_views: int, device, height: int = 16, width: int = 128):
    """The JAX dry run's problem: ring cameras, 4 Béziers and a line whose
    midpoints seed the state (8 Gaussians each, the least capacity), and
    uniform ground truths, from seed 0."""
    rng = np.random.default_rng(0)
    cams = synthetic.ring_cameras(n_views, height, width, device=device)
    cp, _ = synthetic.random_curves(rng, 4, 1)
    state = cs.init_state(cp.mean(axis=1), n_views=n_views, n_gaussians=8,
                          capacity=cs.MIN_CAPACITY, device=device)
    gts = torch.tensor(rng.uniform(size=(n_views, height, width)), dtype=torch.float32,
                       device=device)
    return cams, gts, state


def replicated(ts) -> bool:
    """Whether every rank holds this state bit for bit (each leaf's bytes
    against rank 0's, gathered on the host)."""
    mine = [t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
            for t in _state_leaves(ts).values()]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(e == every[0] for e in every)


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Every stage on the mesh of the initialized group of `n_devices`
    ranks (one rank: no group); raises at the first stage that fails.
    Returns the line rank 0 prints."""
    mesh = ps.make_mesh(n_devices, device=device)
    n_views = n_devices  # one view per rank
    cams, gts, state = _tiny_problem(n_views, mesh.device)
    ts = init_train_state(state)
    geom = (cams[0].height, cams[0].width, cams[0].tanfovx, cams[0].tanfovy)
    opt_cfg, pipe_cfg = OptimizationConfig(), PipelineConfig(tile_capacity=256)
    kw = dict(use_mask=False, mesh_shape=mesh.shape, cam_geom=geom)

    ts2, metrics = ps.parallel_train_step(ts, ps.camera_batch_arrays(cams, mesh),
                                          mesh.block(gts), 0.0, opt_cfg, pipe_cfg, **kw)
    total = float(metrics["total"])
    if not math.isfinite(total) or ts2.step != 1:
        raise RuntimeError(f"step: loss {total}, step {ts2.step}")

    # the chunk the driver runs: K steps of B views from the stacks of all views,
    # this rank's columns of the [K, B] table
    K = 2
    table = [mesh.block([(k * n_views + j) % n_views for j in range(n_views)])
             for k in range(K)]
    stacks = ps.camera_batch_arrays(cams)
    ts2, metrics = ps.parallel_train_steps_scan(ts2, stacks, gts, 0.0, opt_cfg, pipe_cfg,
                                                rows=table, **kw)
    if metrics["total"].shape != (K,) or ts2.step != 1 + K:
        raise RuntimeError(f"chunk: metrics {tuple(metrics['total'].shape)}, step {ts2.step}")

    ts2 = surgery.apply_schedule(ts2, opt_cfg.densify_until_iter, opt_cfg)  # prune, fix opacity
    if not bool(torch.isfinite(ts2.params["curve_points"]).all()):
        raise RuntimeError("surgery: non-finite control points")

    # the driver's re-bucket: the alive rows on the host, repacked at their
    # power-of-two capacity, and one more chunk at it
    ts3 = surgery.repack(surgery.extract(ts2), ts2)
    if ts3.alive.shape[0] > ts2.alive.shape[0]:
        raise RuntimeError("repack: the capacity grew")
    ts3, metrics3 = ps.parallel_train_steps_scan(ts3, stacks, gts, 0.0, opt_cfg, pipe_cfg,
                                                 rows=table, **kw)
    if not bool(torch.isfinite(metrics3["total"]).all()):
        raise RuntimeError("chunk after the repack: non-finite loss")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "chkpnt_dryrun.npz")
        ckpt_mod.save_checkpoint(path, ts3)
        ts4 = ckpt_mod.load_checkpoint(path, ts3)
    a, b = ckpt_mod.named_leaves(ts3), ckpt_mod.named_leaves(ts4)
    if a.keys() != b.keys() or not all(
            np.array_equal(ckpt_mod.leaf_array(a[k]), ckpt_mod.leaf_array(b[k])) for k in a):
        raise RuntimeError("checkpoint: the round trip is not bitwise")
    ts4, metrics4 = ps.parallel_train_step(ts4, ps.camera_batch_arrays(cams, mesh),
                                           mesh.block(gts), 0.0, opt_cfg, pipe_cfg, **kw)
    if not math.isfinite(float(metrics4["total"])):
        raise RuntimeError("step from the restored state: non-finite loss")
    if mesh.size > 1 and not replicated(ts4):
        raise RuntimeError("the ranks' states differ")

    # the render through its captured graph (on the card), against the eager one
    c0 = cams[0]
    img = ps.tile_parallel_render(ts4, (c0.world_to_cam, c0.full_proj, c0.cam_center), geom,
                                  pipe_cfg, 0.0, mesh.shape, n_gaussians=8)
    with torch.no_grad():
        gauss = cs.gaussians(cs.curve_state_of(ts4))
    (replayed,) = ps.tile_parallel_renders(gauss, camera_stacks([c0], torch.float32, mesh.device),
                                           geom, pipe_cfg, 0.0, mesh.shape, [0])
    if tuple(img.shape) != (c0.height, c0.width) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"tile-parallel render: shape {tuple(img.shape)}")
    if not torch.equal(replayed, img):
        raise RuntimeError("tile-parallel render: the graphed render differs from the eager one")
    return (f"dryrun_multichip({n_devices}): loss={total:.5f} stages OK: step, scan-chunk, "
            "surgery, capacity-rebucket, checkpoint-roundtrip, tile-parallel-render")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the multi-device dry run over N ranks")
    p.add_argument("--n", type=int, default=2, help="ranks (one process each)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds the launcher waits for every rank")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:  # one rank
        os.environ["LOCAL_RANK"] = str(args.rank)
        if args.n > 1:
            os.environ["CGT_NUM_PROCESSES"] = str(args.n)
        dev = multihost.rank_device(args.device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        multihost.initialize_distributed(args.init, args.n, args.rank, device=dev)
        try:
            line = dryrun_multichip(args.n, dev)
        finally:
            if args.n > 1:
                dist.destroy_process_group()
        if args.rank == 0:
            print(line, flush=True)
        return 0
    with tempfile.TemporaryDirectory() as td:
        init = f"file://{os.path.join(td, 'rendezvous')}"
        cmd = [sys.executable, "-m", "curve_gaussian_tpu_torch.parallel.dryrun", "--n",
               str(args.n), "--device", args.device, "--init", init]
        res = multihost.run_ranks([cmd + ["--rank", str(r)] for r in range(args.n)],
                                  args.timeout)
    bad = multihost.failures(res)
    for r in res:
        sys.stdout.write(r.output)
    if bad:
        print(f"dryrun: {bad}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
