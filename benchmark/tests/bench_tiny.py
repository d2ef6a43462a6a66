"""A tiny copy of the benchmark for its CPU tests: the tree under a
temporary root, with a configuration, two traffic mixes and their limits
small enough for the program's plain CPU path, and a runner that drives
``benchmark.run.main`` on the CPU (the look for a card skipped)."""
from __future__ import annotations

import io
import json
import shutil
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import torch

torch.set_num_threads(min(4, torch.get_num_threads()))  # tiny tensors: threads only contend
REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}


def tiny_tree(root: Path) -> Path:
    """BENCHMARK.json and benchmark/ under `root`, plus the cells
    ``tiny.dense`` and ``tiny.sparse``; returns `root`."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/abc_nef_800.json").read_text())
    cfg["name"] = "tiny"
    cfg["scene"].update(views=6, height=64, width=96, curves=3, lines=1, samples=64)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    for kind in ("dense", "sparse"):
        t = json.loads((root / f"benchmark/traffic/{kind}.json").read_text())
        t.update(name=f"tiny_{kind}", chunk_steps=4)
        t["population"].update(grid=4, capacity=256)
        t["pipeline"].update(tile_capacity=512)
        if kind == "sparse":
            t["population"]["alive"] = 20
        (root / f"benchmark/traffic/tiny_{kind}.json").write_text(json.dumps(t))
        (root / f"benchmark/limits/tiny.{kind}.json").write_text(json.dumps(TINY_LIMITS))
        spec["workloads"].append(dict(name=f"tiny.{kind}", config="tiny",
                                      traffic=f"tiny_{kind}", chips=1, why="a CPU test"))
    spec["configs"].append(dict(name="tiny", source="a CPU test",
                                file="benchmark/configs/tiny.json", reduced=[], why="a CPU test"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_cpu(root: Path, workload: str, seed: int = 5, seconds: float = 0.5, trace: int = 0):
    """``benchmark.run.main`` on the CPU; returns (exit code, the result
    line's object or None, standard error)."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
