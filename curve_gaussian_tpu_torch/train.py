"""Training CLI of the port, as the repository's ``train.py``: a dataset
scene on disk or a synthetic one.

    python -m curve_gaussian_tpu_torch.train -s output_torch/refscale -r 2
    python -m curve_gaussian_tpu_torch.train --synthetic --iterations 600 --image-size 512
    python -m curve_gaussian_tpu_torch.train --synthetic --device cpu --iterations 30 --image-size 64
    torchrun --nproc-per-node 2 -m curve_gaussian_tpu_torch.train --synthetic \
        --views-per-step 4 --n-devices 2

``--source-path`` loads an EMAP, Blender or COLMAP scene (``data/dataset.py``)
with its train and test views and seed points; ``--synthetic`` makes a
synthetic scene (``make_scene``) with the reference's grid seed cloud and
renders its first two views as test views.  A shortened ``--iterations``
compresses the surgery schedule in proportion.  Training runs through
``engine/loop.train_scene`` on ``--device`` (``cuda`` by default), and the
extracted curves are evaluated into ``eval.json`` against the ground truth:
the synthetic scene's curves, or a dataset scene's ``gt_edges.json`` when it
has one (``scripts/make_ref_scale_scene.py`` writes it).

Under ``torchrun --nproc-per-node N`` (or the ``CGT_NUM_PROCESSES``,
``CGT_COORDINATOR``, ``CGT_PROCESS_ID`` variables) each process is a rank of
one process group and ``--n-devices N`` splits each step's views over the
ranks.  Each rank runs on ``cuda:LOCAL_RANK`` unless ``--device`` names a
device, which then holds every rank.  NCCL, the default on CUDA, takes one
card per rank and captures each step's collectives inside its CUDA graph;
ranks that share a card need ``--dist-backend gloo`` (NCCL refuses them),
whose collectives run eagerly between two graphs a step.  Only rank 0
writes files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from .config import (PRESETS, ModelConfig, OptimizationConfig, PipelineConfig,
                     add_dataclass_args, dataclass_from_args)
from .parallel import multihost


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="curve_gaussian_tpu_torch trainer")
    p.add_argument("--source-path", "-s", default="")
    p.add_argument("--model-path", "-m", default="")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--detector", default="DexiNed")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--white-background", "-w", action="store_true")
    p.add_argument("--invert-edges", default="auto", choices=["auto", "on", "off"],
                   help="edge-map polarity of dataset scenes (auto = scene mean "
                        "intensity > 0.6)")
    p.add_argument("--train-test-exp", action="store_true",
                   help="learn a per-view affine exposure applied to the render "
                        "during training (reference train_test_exp)")
    p.add_argument("--test-iterations", nargs="+", type=int, default=[3000, 10000])
    p.add_argument("--save-iterations", nargs="+", type=int, default=[3000, 10000])
    p.add_argument("--checkpoint-iterations", nargs="+", type=int, default=[])
    p.add_argument("--start-checkpoint", default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", default=None,
                   choices=[None, "default", "pidinet", "replica", "mv2cyl"])
    p.add_argument("--backend", default="pallas", choices=["pallas", "reference"],
                   help="'pallas' renders with the port's CUDA kernels (the JAX "
                        "package's name for its kernels), 'reference' through the oracle")
    p.add_argument("--tile-capacity", type=int, default=PipelineConfig.tile_capacity)
    p.add_argument("--n-gaussians", type=int, default=12)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of one training chunk and the "
                        "training loop's work after it (trace.json), and the chunk's device "
                        "spans (spans.json)")
    p.add_argument("--scan-chunk", type=int, default=100,
                   help="most training steps between two host reads of the metrics")
    p.add_argument("--views-per-step", type=int, default=1,
                   help="views per optimizer step: each step takes the mean gradient of "
                        "this many views, split over the devices")
    p.add_argument("--n-devices", type=int, default=None,
                   help="devices (ranks of the process group, one process each) that "
                        "split each step's views; more than the processes launched raises")
    p.add_argument("--dist-backend", default=None, choices=[None, "nccl", "gloo"],
                   help="torch.distributed backend with more than one process (default: "
                        "nccl on CUDA, gloo on the CPU); nccl needs one card per rank and "
                        "captures the collectives in the CUDA graphs, gloo is for ranks "
                        "that share a card (or the CPU)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic curve scene")
    p.add_argument("--synthetic-seed", type=int, default=0)
    p.add_argument("--synthetic-curves", type=int, default=8)
    p.add_argument("--synthetic-lines", type=int, default=3)
    p.add_argument("--synthetic-views", type=int, default=24)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--synthetic-noise", type=float, default=0.0)
    p.add_argument("--grid-init", type=int, default=15,
                   help="seed grid resolution per axis (reference: 15)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    # every OptimizationConfig hyperparameter as --opt-<name>
    add_dataclass_args(p, OptimizationConfig, prefix="opt_")
    p.add_argument("--detect-anomaly", action="store_true",
                   help="torch.autograd anomaly detection (reference --detect_anomaly)")
    return p.parse_args(argv)


def compress_schedule(opt_cfg: OptimizationConfig, iterations: int) -> OptimizationConfig:
    """The whole surgery schedule scaled to a run of `iterations`."""
    scale = iterations / opt_cfg.iterations
    return dataclasses.replace(
        opt_cfg,
        iterations=iterations,
        densify_from_iter=max(1, int(opt_cfg.densify_from_iter * scale)),
        densify_until_iter=max(2, int(opt_cfg.densify_until_iter * scale)),
        conn_from_iter=max(2, int(opt_cfg.conn_from_iter * scale)),
        densification_interval=max(1, int(opt_cfg.densification_interval * scale)),
        prune_trim_interval=max(2, int(opt_cfg.prune_trim_interval * scale)),
        split_interval=max(1, int(opt_cfg.split_interval * scale)),
        split_from_iter=max(1, int(opt_cfg.split_from_iter * scale)),
        merge_interval=max(1, int(opt_cfg.merge_interval * scale)),
        position_lr_max_steps=max(1, int(opt_cfg.position_lr_max_steps * scale)),
    )


def gt_edge_dict(scene):
    """The synthetic scene's ground-truth curves in the extraction format."""
    return {
        "curves_ctl_pts": scene.curves[scene.is_bezier].reshape(-1, 12).tolist(),
        "lines_end_pts": scene.curves[~scene.is_bezier][:, [0, 3], :].reshape(-1, 6).tolist(),
    }


def main(argv=None):
    """Train (and evaluate) one scene; returns the TrainResult.  With more
    than one process, each is a rank (``multihost.distributed``)."""
    args = parse_args(argv)
    with multihost.distributed(args.device, args.dist_backend) as dev:
        return _main(args, str(dev))


def _main(args, device: str):
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    from .data import synthetic
    from .engine.loop import train_scene
    from .eval import metrics as M
    from .eval.extract import sample_edge_dict

    sp = args.source_path
    preset = args.preset or (
        "replica" if "Replica" in sp
        else "pidinet" if "ABC" in sp and args.detector == "PidiNet" else "default")
    opt_cfg = dataclass_from_args(args, OptimizationConfig, base=PRESETS[preset](),
                                  prefix="opt_")
    if args.iterations is not None:
        opt_cfg = compress_schedule(opt_cfg, args.iterations)
    pipe_cfg = PipelineConfig(backend=args.backend, tile_capacity=args.tile_capacity)
    model_cfg = ModelConfig(
        source_path=args.source_path, model_path=args.model_path, detector=args.detector,
        resolution=args.resolution, white_background=args.white_background, eval=args.eval,
        n_gaussians=args.n_gaussians, train_test_exp=args.train_test_exp,
        invert_edges=args.invert_edges,
    )

    if args.synthetic:
        print("generating synthetic scene...", flush=True)
        scene = synthetic.make_scene(
            seed=args.synthetic_seed, n_curves=args.synthetic_curves,
            n_lines=args.synthetic_lines, n_views=args.synthetic_views,
            height=args.image_size, width=args.image_size, backend=args.backend,
            noise=args.synthetic_noise, device=device,
        )
        cameras, edge_maps = scene.cameras, scene.edge_maps
        test_cams, test_maps = cameras[:2], edge_maps[:2]
        seed_points = synthetic.grid_seed_points(args.grid_init)
        model_path = args.model_path or f"output_torch/synth/seed{args.synthetic_seed}"
        gt_dict = gt_edge_dict(scene)
    else:
        from .data.dataset import load_scene

        scene = load_scene(model_cfg, device=device)
        cameras, edge_maps = scene.train_cameras, scene.train_edge_maps
        test_cams, test_maps = scene.test_cameras, scene.test_edge_maps
        seed_points = scene.seed_points
        model_path = args.model_path or "output_torch/run"
        gt_dict = None
        gt_path = os.path.join(args.source_path, "gt_edges.json")
        if args.source_path and os.path.exists(gt_path):
            with open(gt_path) as f:
                gt_dict = json.load(f)
    rank0 = multihost.group_size() == 1 or torch.distributed.get_rank() == 0
    if rank0:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "cfg_args"), "w") as f:
            f.write(repr(vars(args)))

    result = train_scene(
        cameras, edge_maps, seed_points, model_cfg, opt_cfg, pipe_cfg, model_path,
        test_cameras=test_cams, test_edge_maps=test_maps,
        test_iterations=args.test_iterations,
        save_iterations=sorted(set(args.save_iterations + [opt_cfg.iterations])),
        checkpoint_iterations=args.checkpoint_iterations,
        start_checkpoint=args.start_checkpoint, quiet=args.quiet, seed=args.seed,
        views_per_step=args.views_per_step, n_devices=args.n_devices,
        scan_chunk=args.scan_chunk, profile_dir=args.profile_dir, device=device,
    )

    if gt_dict is not None and rank0:
        pred_pts, pred_dirs = sample_edge_dict(result.edge_dict, with_directions=True)
        gt_pts, gt_dirs = sample_edge_dict(gt_dict, with_directions=True)
        res = M.evaluate_edges(pred_pts, gt_pts, pred_dirs, gt_dirs)
        print("eval vs GT curves:")
        for k, v in res.items():
            print(f"  {k}: {v:.4f}")
        with open(os.path.join(model_path, "eval.json"), "w") as f:
            json.dump(res, f, indent=1)
    if rank0:
        print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
