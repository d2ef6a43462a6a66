"""The full-schedule quality run of the reference-scale scene, on the card:
make the scene with the port's scene maker at its defaults (1600², 50
views), train it with the port's CLI at ``-r 2 --eval`` on the default
schedule (10,000 iterations, test renders at 3,000 and 10,000), and report
what judges it.  The recipe is fixed; it takes no size or trainer option.

    python -m curve_gaussian_tpu_torch.scripts.refscale_quality --out output_torch/quality
    python -m curve_gaussian_tpu_torch.scripts.refscale_quality --out ... --report-dir <dir>

It prints, and writes to ``<report-dir>/summary.json`` (with copies of
``eval.json``, ``metrics.jsonl`` and ``parametric_edges.json``): the card's
name and power limit, ``eval.json`` (Chamfer, precision, recall and F-score
at 5, 10 and 20 mm, direction similarity), the test PSNR and L1 at each test
iteration, the extracted curves and lines, the visible Gaussians at the last
logged step, the loss tail, iterations per second over ``train_scene``, host
seconds by phase, the surgery events and the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="full-schedule refscale quality run")
    p.add_argument("--out", default="output_torch/quality",
                   help="directory for the scene (<out>/scene) and the run (<out>/run)")
    p.add_argument("--report-dir", default=None,
                   help="also write summary.json and the run's small files here")
    return p.parse_args(argv)


def smi_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return r.stdout.strip() or r.stderr.strip()


def main(argv=None) -> dict:
    from .. import resolve_device
    from .. import train as TR
    from . import make_ref_scale_scene as MK

    args = parse_args(argv)
    resolve_device("cuda")
    scene_dir = os.path.join(args.out, "scene")
    run_dir = os.path.join(args.out, "run")
    summary = {"card": smi_line(), "torch": torch.__version__}
    print(summary["card"], flush=True)

    shutil.rmtree(scene_dir, ignore_errors=True)
    t0 = time.time()
    made = MK.make_ref_scale_scene(["--out", scene_dir], quiet=True)
    summary["scene_seconds"] = time.time() - t0
    summary["scene_overflow_views"] = int(np.count_nonzero(made["overflow"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = TR.main(["-s", scene_dir, "-m", run_dir, "-r", "2", "--eval", "--quiet"])
    summary["main_seconds"] = time.time() - t0
    summary["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    sec = res.seconds
    iters = int(res.ts.step)
    summary["iterations"] = iters
    summary["train_seconds"] = sec["train"]
    summary["seconds_by_phase"] = {k: v for k, v in sec.items() if k != "train"}
    summary["captures"] = None if res.graphs is None else len(res.graphs.captures)
    summary["curves"] = len(res.edge_dict["curves_ctl_pts"])
    summary["lines"] = len(res.edge_dict["lines_end_pts"])
    summary["events"] = res.events

    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    steps = [r for r in rows if "total" in r]
    summary["it_per_s"] = iters / sec["train"]
    summary["tests"] = [{"iter": r["iter"], "l1": r["test_l1"], "psnr": r["test_psnr"]}
                        for r in rows if "test_l1" in r]
    summary["loss_tail"] = [{"iter": r["iter"], "total": r["total"],
                             "n_visible": r.get("n_visible")} for r in steps[-5:]]
    with open(os.path.join(run_dir, "eval.json")) as fh:
        summary["eval"] = json.load(fh)

    print(json.dumps(summary, indent=1, default=float), flush=True)
    if args.report_dir:
        os.makedirs(args.report_dir, exist_ok=True)
        with open(os.path.join(args.report_dir, "summary.json"), "w") as fh:
            json.dump(summary, fh, indent=1, default=float)
        for f in ("eval.json", "metrics.jsonl", "parametric_edges.json"):
            shutil.copy(os.path.join(run_dir, f), os.path.join(args.report_dir, f))
    return summary


if __name__ == "__main__":
    main()
