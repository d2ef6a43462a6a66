"""Device spans (``engine/spans.py``): the step's device time by module.

On the CPU the step body runs eagerly and a stamp is the host's
nanosecond clock, so these tests see the same marks, in the same order, as
the captured step on the card: every step of a chunk with spans on records
all six spans, they tile the step exactly, and nothing else of the step
changes; with spans off nothing is stamped.  The last two tests need a
CUDA card (``pytest --noconftest -m cuda tests/test_torch_port_spans.py``):
the graph with spans holds exactly one more kernel node per stamp than the
graph without them, beside which it is captured; and a ``StepGraphs``
dropped after chunks whose stamps and timings wait to be summed is freed
at once, its graphs with it (a graph of NCCL collectives kept alive by a
reference cycle blocks ``destroy_process_group``).
"""
import gc
import json
import weakref

import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.engine import spans
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.models import surgery as psurg
from curve_gaussian_tpu_torch.parallel import sharding

H = W = 32
M = 4
PIPE = PipelineConfig(tile_capacity=128, big_capacity=64)
OPT = OptimizationConfig()
# the marks of a one-view step: the forward's module ends, then the
# backward's (the image's, the fields' and the Gaussians' gradients and
# the return of autograd.grad), then the update's end
VIEW_MARKS = ("sample", "project", "bin", "project", "blend", "loss",
              "loss", "blend", "project", "sample")
STEP_MARKS = VIEW_MARKS + ("adam",)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _scene(device="cpu", n_curves=40, seed=0):
    rng = np.random.default_rng(seed)
    cams = psyn.ring_cameras(3, H, W, device=device)
    gts = torch.tensor(rng.uniform(size=(3, H, W)) ** 4, dtype=torch.float32, device=device)
    pts = rng.uniform(0.3, 0.7, size=(n_curves, 3))
    ts = ptrain.init_train_state(pcs.init_state(pts, n_views=3, n_gaussians=M, device=device))
    stacks = tuple(torch.stack([getattr(c, f) for c in cams])
                   for f in ("world_to_cam", "full_proj", "cam_center"))
    return stacks, gts, ts, (H, W, cams[0].tanfovx, cams[0].tanfovy)


def _chunk(graphs, rows=(2, 0, 1), device="cpu"):
    stacks, gts, ts, geom = _scene(device)
    return ptrain.train_steps_scan(ts, stacks, gts, 0.0, OPT, PIPE, use_mask=False,
                                   n_gaussians=M, cam_geom=geom, rows=list(rows), graphs=graphs)


def _assert_tiled(graphs, steps, marks):
    """Every step of the last chunk gave each of the six spans its
    intervals, none negative, and they add up to the step's first to last
    stamp; the totals count the steps and hold the same sums."""
    ms = graphs.span_ms()
    names, table = graphs.last_stamps
    assert names == marks and set(names) == set(spans.SPANS)
    t = table[:, : len(names) + 1]
    assert t.shape[0] == steps == graphs.span_totals.steps
    d = t[:, 1:] - t[:, :-1]
    assert bool((d >= 0).all()) and bool((t[:, -1] > t[:, 0]).all())
    assert torch.equal(d.sum(dim=1), t[:, -1] - t[:, 0])
    tot = graphs.span_totals
    assert list(ms) == list(spans.SPANS) and sum(tot.ns.values()) == tot.busy_ns
    assert sum(ms.values()) == pytest.approx(tot.busy_ns / steps * 1e-6, rel=1e-12)
    assert 0 <= graphs.idle_between_steps() < 1


def test_spans_tile_every_step():
    graphs = ptrain.StepGraphs(spans=True)
    _chunk(graphs)
    _assert_tiled(graphs, 3, STEP_MARKS)
    assert graphs.exchange_bytes is None  # one rank exchanges nothing


def test_spans_leave_metrics_and_state_bitwise():
    on_ts, on_m = _chunk(ptrain.StepGraphs(spans=True))
    off_ts, off_m = _chunk(ptrain.StepGraphs())
    assert list(on_m) == list(off_m) and all(torch.equal(on_m[k], off_m[k]) for k in on_m)
    a, b = ptrain._state_leaves(on_ts), ptrain._state_leaves(off_ts)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_spans_off_stamp_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(spans._Recorder, "stamp", lambda self, *a, **k: calls.append(a))
    monkeypatch.setattr(ptrain._Buffers, "stamp_table",
                        lambda self: calls.append("table") or torch.zeros(1))
    graphs = ptrain.StepGraphs()
    _chunk(graphs)
    assert calls == [] and graphs.last_stamps is None
    assert graphs.span_ms() == {} and graphs.idle_between_steps() is None


def test_batch_step_records_the_spans():
    """The B-view step (two views a step) marks each view's modules in
    turn, then its one update."""
    stacks, gts, ts, geom = _scene()
    graphs = ptrain.StepGraphs(sharding.batch_step(1), spans=True)
    sharding.parallel_train_steps_scan(ts, stacks, gts, 0.0, OPT, PIPE, use_mask=False,
                                       mesh_shape=None, cam_geom=geom,
                                       rows=[[0, 1], [2, 0]], graphs=graphs)
    _assert_tiled(graphs, 2, VIEW_MARKS * 2 + ("adam",))


def test_totals_idle_between_steps():
    """Idle is the gaps between one step's last stamp and the next one's
    first, across chunks too, but not across a pause."""
    tot = spans.Totals()
    tot.add(torch.tensor([[0, 2, 5, 0], [6, 7, 10, 0]]), ("sample", "adam"))
    assert (tot.ns, tot.steps, tot.busy_ns, tot.idle_ns) == ({"sample": 3, "adam": 6}, 2, 9, 1)
    tot.add(torch.tensor([[14, 15, 16, 9]]), ("sample", "adam"))
    assert (tot.busy_ns, tot.idle_ns) == (11, 5)
    tot.pause()
    tot.add(torch.tensor([[100, 101, 103, 0]]), ("sample", "adam"))
    assert (tot.busy_ns, tot.idle_ns, tot.steps) == (14, 5, 4)
    assert tot.idle_share() == pytest.approx(5 / 19)
    assert tot.ms() == {"sample": 5 / 4 * 1e-6, "adam": 9 / 4 * 1e-6}


def test_anchored_by_the_trace_stamp_kernels(tmp_path):
    """The last stamp kernels of the trace are the table's stamps in
    order (an eager warm-up's come first); the median difference puts the
    table on the trace's clock."""
    table = torch.tensor([[10_000, 12_000], [15_000, 16_000]], dtype=torch.int64)
    kernels = [500.0, 1010.0, 1012.0, 1015.0, 1016.3]  # microseconds: one warm-up stamp first
    events = [dict(cat="kernel", name=f"void (anonymous namespace)::{spans.KERNEL}(long long*)",
                   ts=t, dur=1.0) for t in kernels]
    events.append(dict(cat="kernel", name="other", ts=0.0, dur=1.0))
    (tmp_path / "trace.json").write_text(json.dumps(dict(traceEvents=events)))
    out = spans.anchored(str(tmp_path / "trace.json"), ("adam",), table)
    assert out["marks"] == ["adam"] and out["offset_ns"] == 1_000_000
    assert out["stamps_us"] == [[1010.0, 1012.0], [1015.0, 1016.0]]
    out = spans.anchored(str(tmp_path / "trace.json"), ("adam",), torch.zeros((3, 2)))
    assert out["offset_ns"] is None and out["stamps_us"] is None


def test_surgery_span_per_fired_op():
    """``apply_schedule`` runs each fired op inside its span, in the
    schedule's order."""
    _, _, ts, _ = _scene()
    opt = OptimizationConfig(densify_from_iter=2, densify_until_iter=8,
                             densification_interval=4)
    seen = []

    def span(op):
        seen.append(op)
        return spans.host(f"loop.surgery.{op}")

    for it in (4, 8):
        psurg.apply_schedule(ts, it, opt, span=span)
    assert seen == psurg.fired_ops(4, opt) + psurg.fired_ops(8, opt) == [
        "densify", "densify_until"]


def test_profile_dir_writes_the_spans(tmp_path):
    """``--profile-dir``'s chunk runs with spans: ``spans.json`` beside the
    trace, ``TrainResult.span_ms``, and each surgery event's seconds by
    op; the other chunks run without them."""
    cams = psyn.ring_cameras(3, H, W, device="cpu")
    rng = np.random.default_rng(0)
    maps = [rng.uniform(size=(H, W)).astype(np.float32) ** 4 for _ in range(3)]
    opt = OptimizationConfig(iterations=8, densify_from_iter=2, densify_until_iter=6,
                             densification_interval=4)
    res = ploop.train_scene(cams, maps, rng.uniform(0.3, 0.7, size=(20, 3)),
                            ModelConfig(n_gaussians=M), opt, PIPE, str(tmp_path / "run"),
                            quiet=True, scan_chunk=4, profile_dir=str(tmp_path / "prof"),
                            device="cpu")
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert got["span_ms"] == res.span_ms and list(got["span_ms"]) == list(spans.SPANS)
    assert "exchange_ms_by_rank" not in got and res.exchange_bytes is None
    assert got["marks"] == list(STEP_MARKS) and got["steps"] == res.graphs.span_totals.steps
    assert got["steps"] < int(res.ts.step)  # only the profiled chunk
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ranges = {e["name"]: e.get("cat") for e in trace["traceEvents"]
              if e.get("name", "").startswith(("chunk.", "loop."))}
    assert {"chunk.tables", "chunk.load", "chunk.replay", "chunk.out", "loop.readback",
            "loop.capacity", "loop.save"} <= set(ranges)
    # operator ranges: a user annotation would take the kernels launched
    # inside it from the device-side span of a caller's annotation
    assert set(ranges.values()) == {"cpu_op"}
    surgery = [e for e in res.events if e["kind"] == "surgery"]
    assert surgery and all(list(e["op_seconds"]) == e["ops"] for e in surgery)
    assert all(0 <= sum(e["op_seconds"].values()) <= e["seconds"] for e in surgery)


@pytest.mark.cuda
def test_spans_graph_on_card():
    """One ``StepGraphs`` runs a chunk without spans, one with them and one
    without again: two captures, the graph without spans kept.  The graph
    with spans holds the other's kernel nodes in the same order and one
    stamp kernel per stamp, nothing else more; its steps' stamps are
    ordered and the steps' state and metrics are bitwise the other's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU form")
    from curve_gaussian_tpu_torch.engine.graph_nodes import graph_nodes, kernel_names

    graphs = ptrain.StepGraphs()
    off_ts, off_m = _chunk(graphs, rows=(2, 0, 1, 1, 2), device="cuda")
    graphs.spans = True
    on_ts, on_m = _chunk(graphs, rows=(2, 0, 1, 1, 2), device="cuda")
    graphs.spans = False
    _chunk(graphs, device="cuda")
    assert len(graphs.captures) == 2 and [c["spans"] for c in graphs.captures] == [False, True]
    _assert_tiled(graphs, 5, STEP_MARKS)
    by = {g.record["spans"]: g.graph for g in graphs._graphs.values()}
    nodes = {k: graph_nodes(g) for k, g in by.items()}
    names = {k: kernel_names(g) for k, g in by.items()}
    stamps = len(STEP_MARKS) + 1
    assert nodes[True]["kernel"] == nodes[False]["kernel"] + stamps
    assert {k: v for k, v in nodes[True].items() if k != "kernel"} == {
        k: v for k, v in nodes[False].items() if k != "kernel"}
    assert sum(spans.KERNEL in n for n in names[True]) == stamps
    assert [n for n in names[True] if spans.KERNEL not in n] == names[False]
    _, table = graphs.last_stamps
    t = table[:, :stamps]
    assert bool((t[1:, 0] >= t[:-1, -1]).all())
    assert all(torch.equal(on_m[k], off_m[k]) for k in on_m)
    a, b = ptrain._state_leaves(on_ts), ptrain._state_leaves(off_ts)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_step_graphs_freed_without_gc_on_card():
    """Chunks leave their stamps to be summed later; the object holding
    them is still freed when its last reference goes, with the cycle
    collector off, and the graph it captured with it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunk's deferred sums exist only there")
    gc.collect()
    gc.disable()
    try:
        graphs = ptrain.StepGraphs(spans=True)
        _chunk(graphs, device="cuda")
        assert graphs._pending  # the stamps, summed at the next read
        freed = weakref.ref(graphs)
        graph = weakref.ref(graphs.latest_graph())
        del graphs
        assert freed() is None and graph() is None
    finally:
        gc.enable()
