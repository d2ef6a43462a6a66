"""BENCHMARK.json against the contract's shape, and every cell resolving to
its configuration, traffic mix, limits and metric readers by name."""
from __future__ import annotations

import json
import re

import pytest

from bench_tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a width may never be cut: these keys stay as the source states them
WIDTHS = ("n_gaussians", "height", "width")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = REPO / conf["file"]
    assert path.is_file() and conf["file"].startswith("benchmark/")
    body = json.loads(path.read_text())
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    assert set(conf["reduced"]) <= set(body) and not set(conf["reduced"]) & set(WIDTHS)
    assert len(conf["why"]) <= 200 and len(conf["source"]) <= 200


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(work):
    from benchmark import run

    cell = run.resolve(work["name"])
    assert cell.traffic["name"] == work["traffic"]
    assert cell.config["name"] == work["config"]
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_views_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(run.reader(m["name"]))
    assert len(work["why"]) <= 200
