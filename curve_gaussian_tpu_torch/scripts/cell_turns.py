"""The driver cell and the dataset cell of ``chip_smoke.py`` (phases 9 and
10d) through two checkouts of the repository in turns (other, this, this,
other), on the card: iterations per second over ``train_scene`` and host
seconds by phase of each run, so that two commits compare on one card in
one call.

    python -m curve_gaussian_tpu_torch.scripts.cell_turns --other <checkout>

The dataset scene is made once, by this checkout's scene maker at its
defaults (1600², 50 views), under ``--out``.  Each run is a process of its
own with ``PYTHONPATH`` at its checkout, which prints one JSON line per
cell; this script prints each line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# chip_smoke.py's DRIVER_ARGS (without the checkpoint) and DATASET_ARGS
DRIVER_ARGS = ["--synthetic", "--image-size", "512", "--grid-init", "15", "--n-gaussians", "12",
               "--iterations", "600", "--test-iterations", "300", "600", "--seed", "0",
               "--quiet"]
DATASET_ARGS = ["-r", "2", "--eval", "--iterations", "600", "--test-iterations", "300", "600",
                "--seed", "0", "--quiet"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the driver and dataset cells of two checkouts "
                                            "in turns")
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--out", default="output_torch/cell_turns")
    p.add_argument("--cells", default=None, help=argparse.SUPPRESS)  # a run's own process
    return p.parse_args(argv)


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


def main(argv=None) -> None:
    args = parse_args(argv)
    out = os.path.abspath(args.out)  # the runs' processes start in their checkouts
    scene = os.path.join(out, "refscale")
    if args.cells:
        run_cells(out, scene, args.cells)
        return
    from . import make_ref_scale_scene as MK
    from .refscale_quality import smi_line

    MK.make_ref_scale_scene(["--out", scene], quiet=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    for turn, tag in enumerate(("other", "this", "this", "other")):
        env = dict(os.environ, PYTHONPATH=trees[tag])
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", args.other,
                            "--out", out, "--cells", f"{tag}{turn}"],
                           env=env, capture_output=True, text=True, cwd=trees[tag])
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        if r.returncode:
            sys.exit(f"the {tag} run failed:\n{r.stderr[-4000:]}")
    print(smi_line(), flush=True)


if __name__ == "__main__":
    main()
