"""The spans pass (``benchmark/spans.py``) on the CPU: the six modules of
the program's device spans over its steps, their sum, the idle between
steps; nothing where the program has no spans."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench_tiny import tiny_tree

SPANS = ["sample", "project", "bin", "blend", "loss", "adam"]


def test_spans_pass_reads_the_six_modules(tmp_path):
    from benchmark import run, spans

    cell = run.resolve("tiny.sparse", tiny_tree(tmp_path))
    _, _, prog, ts0, views, _ = run.prepare(cell, 5, torch.device("cpu"))
    got = spans.spans_pass(prog, ts0, views, 1, 3, chunks=2)
    assert list(got["ms"]) == SPANS and got["steps"] == 6 and not prog.graphs.spans
    assert all(v >= 0 for v in got["ms"].values())
    assert got["step_ms"] == pytest.approx(sum(got["ms"].values()))
    clock = spans.clock(prog.graphs)
    assert 0 <= got["idle_share"] < 1 and clock["min_ns"] >= clock["tick_ns"] > 0
    prog.chunk(ts0, [views.take(1) for _ in range(2)])  # a chunk between passes, without spans
    again = spans.spans_pass(prog, ts0, views, 1, 3, chunks=1)
    assert again["steps"] == 3 and list(again["ms"]) == SPANS  # each pass sums its own steps


def test_spans_pass_of_a_program_without_spans():
    from benchmark import spans

    assert spans.spans_pass(SimpleNamespace(graphs=object()), None, None, 1, 3) is None
