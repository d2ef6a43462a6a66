"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath comes out not correct; the sound path comes out
correct.  The fault a one-view training cell can have: a step that
returns its state unchanged.  Those a cell over four ranks can have
besides: the exchange between the ranks left out, and half of the batch
left out, the mean taken over the rest (four gloo ranks on the CPU)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import run_cpu, tiny_tree

from curve_gaussian_tpu_torch.engine import train as T


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.sparse"])
def test_sound_run_is_correct(root, cell):
    rc, res, err = run_cpu(root, cell, seed=2 ** 33 + 5)
    assert rc == 0 and res["correct"], err
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check change_gap ")


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.sparse"])
def test_unchanged_state_is_not_correct(root, cell, monkeypatch):
    step = T.train_step

    def frozen(ts, *args, **kw):
        _, metrics = step(ts, *args, **kw)
        return ts, metrics

    monkeypatch.setattr(T, "train_step", frozen)
    rc, res, err = run_cpu(root, cell, seed=2 ** 33 + 5)
    assert rc == 0 and not res["correct"], err
    # no moment and no change: each reads 1 by the worst leaf
    assert res["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.fixture(scope="module")
def root4(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("bench4"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "benchmark/traffic/tiny_dense.json").read_text())
    mix.update(name="tiny_views4", views_per_step=4)
    (root / "benchmark/traffic/tiny_views4.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/tiny.views4.json").write_text(
        (root / "benchmark/limits/tiny.dense.json").read_text())
    spec["workloads"].append(dict(name="tiny.views4", config="tiny", traffic="tiny_views4",
                                  chips=4, why="a CPU test"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("fault", ["", "exchange", "half"])
def test_four_ranks(root4, fault):
    from benchmark.ranks import free_port

    script = Path(__file__).with_name("bench_ranks.py")
    port = str(free_port())
    cmd = lambda r: [sys.executable, str(script), str(root4), str(r), port,  # noqa: E731
                     *([fault] if fault else [])]
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["correct"] == (not fault), res["checks"]
    assert res["device"]["count"] == 4 and res["attempted"] % 4 == 0
