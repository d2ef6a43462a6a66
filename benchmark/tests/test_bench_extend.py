"""A configuration, a traffic mix and a per-layer metric added as new files
and entries, with no file of the harness edited, are found and run."""
from __future__ import annotations

import json

from bench_tiny import run_cpu, tiny_tree


def test_added_files_are_found_and_run(tmp_path):
    root = tiny_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration: the tiny one at another size
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg.update(name="tiny_wide")
    cfg["scene"].update(width=128, views=5)
    (root / "benchmark/configs/tiny_wide.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(name="tiny_wide", source="a CPU test", reduced=[],
                                file="benchmark/configs/tiny_wide.json", why="a CPU test"))
    # a new traffic mix: two views a step
    mix = json.loads((root / "benchmark/traffic/tiny_dense.json").read_text())
    mix.update(name="tiny_views2", views_per_step=2)
    (root / "benchmark/traffic/tiny_views2.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/tiny_wide.views2.json").write_text(
        (root / "benchmark/limits/tiny.dense.json").read_text())
    spec["workloads"].append(dict(name="tiny_wide.views2", config="tiny_wide",
                                  traffic="tiny_views2", chips=1, why="a CPU test"))
    # a new per-layer metric: a reader of its own
    (root / "benchmark/metrics/profiled_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['traced_steps'] * ctx['views_per_step'])\n")
    spec["per_layer"].append(dict(name="profiled_steps", unit="views", better="higher",
                                  source="program_counter", layer="chunk and step",
                                  moves="train_views_per_s", workloads=["tiny_wide.views2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    rc, res, err = run_cpu(root, "tiny_wide.views2", seconds=0.2, trace=1)
    assert rc == 0, err
    assert res["metrics"]["profiled_steps"] == {"value": 8.0, "unit": "views"}
    assert res["correct"] and res["attempted"] % 2 == 0
    rc, res, err = run_cpu(root, "tiny_wide.views2", seconds=0.2)
    assert rc == 0 and set(res["metrics"]) == {"train_views_per_s", "setup_s"}, err
    assert {p: p.read_bytes() for p in before} == before  # no harness file was edited
