"""Batch driver: train every scan under a data root with the port, then
evaluate, as the repository's ``scripts/run_batch_abc.py`` does with the
JAX package (reference scripts/run_batch_ABC.py).

One subprocess per scan (``python -m curve_gaussian_tpu_torch.train``),
skipping a scan whose parametric_edges.json exists: that file is the
recovery story, so running the batch again resumes where it stopped.
``--in-process`` trains every scan in this process through
``train.main(argv)`` instead; a scan's failure is caught, recorded and the
batch goes on.  ``--gt-base-dir`` evaluates the outputs against the ABC
ground truth (``eval/abc.evaluate_batch``) into
<output-root>/eval_summary.json.

    python -m curve_gaussian_tpu_torch.scripts.run_batch_abc --data-root <scans> \\
        --output-root output_torch/abc --gt-base-dir <abc_gt> [--extra --iterations 3000]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import traceback

from .. import resolve_device
from .. import train as train_cli


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train and evaluate every scan under a root")
    p.add_argument("--data-root", required=True, help="directory of per-scan scenes")
    p.add_argument("--output-root", default="output_torch/abc")
    p.add_argument("--resolution", "-r", type=int, default=2)
    p.add_argument("--detector", default="DexiNed")
    p.add_argument("--gt-base-dir", default=None,
                   help="ABC GT directory (obj/ and chunk_0000_*.json) for the evaluation")
    p.add_argument("--in-process", action="store_true",
                   help="train the scans in this process, one after another")
    p.add_argument("--device", default="cuda", help="torch device of every scan (default cuda)")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra arguments forwarded to the trainer")
    return p.parse_args(argv)


def main(argv=None):
    """Train the scans that are not done, then evaluate when asked.
    Returns (done, skipped, failed): the scans trained, skipped and failed,
    each a sorted list of names."""
    args = parse_args(argv)
    resolve_device(args.device)  # a missing card fails the batch, not each scan
    scans = sorted(d for d in os.listdir(args.data_root)
                   if os.path.isdir(os.path.join(args.data_root, d)))
    print(f"{len(scans)} scans", flush=True)
    done, skipped, failed = [], [], []
    for scan in scans:
        out_dir = os.path.join(args.output_root, scan)
        if os.path.exists(os.path.join(out_dir, "parametric_edges.json")):
            print(f"skip {scan} (already done)", flush=True)
            skipped.append(scan)
            continue
        argv_s = ["-s", os.path.join(args.data_root, scan), "-m", out_dir,
                  "-r", str(args.resolution), "--detector", args.detector,
                  "--device", args.device] + args.extra
        if args.in_process:
            print(f"[in-process] train {' '.join(argv_s)}", flush=True)
            try:
                train_cli.main(argv_s)
            except Exception:  # one scan's failure must not end the batch
                print(f"scan {scan} failed:\n{traceback.format_exc()}", file=sys.stderr,
                      flush=True)
                failed.append(scan)
                continue
        else:
            cmd = [sys.executable, "-m", "curve_gaussian_tpu_torch.train"] + argv_s
            print(" ".join(cmd), flush=True)
            ret = subprocess.call(cmd)
            if ret != 0:
                print(f"scan {scan} failed with {ret}", file=sys.stderr, flush=True)
                failed.append(scan)
                continue
        done.append(scan)

    if args.gt_base_dir:
        from ..eval.abc import evaluate_batch

        agg = evaluate_batch(args.output_root, scans, args.gt_base_dir,
                             log_path=os.path.join(args.output_root, "eval_summary.json"))
        for k in sorted(agg):
            print(f"{k}: {agg[k]}")
    print(f"done {done}, skipped {skipped}, failed {failed}", flush=True)
    return done, skipped, failed


if __name__ == "__main__":
    sys.exit(1 if main()[2] else 0)
