"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration file, its traffic mix
(``benchmark/traffic/<mix>.json``), its limits
(``benchmark/limits/<cell>.json``) and, with ``--trace 1``, its per-layer
metrics' readers (``benchmark/metrics/<metric>.py``) by their names, so a
new cell is new files and entries, with no edit here.

Set-up (``setup_s``, from the process's start): the scene and the initial
population from the seed on the card (``scene.py``), the program's state,
its first three steps through the window's own chunk call (the first one
builds the kernels and captures the step graph; what they give is kept for
the comparison), and one warm-up chunk.  The window then runs chunks of
``chunk_steps`` steps, views popped at random without replacement in each
epoch, until ``--seconds`` have passed; every ``RESTART_CHUNKS`` chunks the
state goes back to the phase's initial state, so every commit trains the
same states.  ``train_views_per_s`` is the views trained over the window's
host seconds, each chunk's metrics read back once as the driver reads them.
With ``--trace 1`` CUDA events time each chunk of the window, one more
chunk after it is profiled, and the per-layer readers take both; the
profiled chunk's steps are then replayed one at a time from its input
state (bitwise the same steps) and every ``COUNT_EVERY``-th step's tile
lists are kept for the roofline counts.

Once the window has closed: the peak memory, the program freed, then the
plain reference over the same three steps (``compare.py``), each number
printed beside its limit as the last lines on standard error and under
``checks``, the last key of the result line.  Without a card (or with
fewer than the cell asks for) it exits 2 and prints no result; with JAX or
the JAX package loaded it exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

import torch  # noqa: E402

from . import compare, ranks as RK, reference, scene as SC, trace as TR  # noqa: E402
from .program import Program  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "curve_gaussian_tpu")
# every 5 chunks (500 steps at the driver's 100) the window's state goes back
# to the phase's initial state, so a faster program trains the same states
RESTART_CHUNKS = 5
# the profiled chunk's every 10th step is binned for the roofline counts
COUNT_EVERY = 10


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of ``BENCHMARK.json`` under `root`, with its files."""
    spec = _load(root / "BENCHMARK.json")
    work = [w for w in spec["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    reports = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return Cell(name, w, _load(root / conf["file"]),
                _load(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
                _load(root / "benchmark" / "limits" / f"{name}.json"),
                [m for m in spec["end_to_end"] if reports(m)],
                [m for m in spec["per_layer"] if reports(m)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card() -> dict:
    """The card's name and power limit (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    limit = None
    if out.returncode == 0 and "," in out.stdout:
        try:
            limit = float(out.stdout.strip().split(",")[-1])
        except ValueError:
            pass
    return dict(kind=torch.cuda.get_device_name(0), power_limit_w=limit)


class Views:
    """The driver's view order: popped at random without replacement,
    epoch after epoch, from ``random.Random(seed)``."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.stack = n, random.Random(seed), []

    def take(self, k: int) -> list:
        out = []
        for _ in range(k):
            if not self.stack:
                self.stack = list(range(self.n))
            out.append(self.stack.pop(self.rng.randrange(len(self.stack))))
        return out


def _host(metrics: dict) -> dict:
    """A chunk's per-step metrics on the host, in one transfer."""
    names = list(metrics)
    rows = torch.stack([metrics[n] for n in names], dim=1).cpu()
    return {n: rows[:, i] for i, n in enumerate(names)}


def _bad_steps(m: dict) -> tuple:
    """(steps whose loss is not finite or whose binning dropped a candidate,
    steps whose loss is not finite)."""
    nonfinite = ~torch.isfinite(m["total"])
    bad = nonfinite.clone()
    for k in ("overflow", "big_overflow"):
        if k in m:
            bad |= m[k] > 0
    return int(bad.sum()), int(nonfinite.sum())


def count_samples(prog: Program, ts, rows: list, every: int, config: dict, traffic: dict,
                  scene, binned: bool = True) -> list:
    """The tile lists of every `every`-th step of a chunk, by replaying its
    steps one at a time from its input state `ts` (the same graph, so the
    same bits) and binning each sampled step's state and this rank's views
    with the benchmark's own projection and binning (every rank replays;
    with `binned` False this one bins nothing)."""
    cams, m = scene.cams, config["model"]["n_gaussians"]
    pipe, use_mask = traffic["pipeline"], traffic["phase"]["use_mask"]
    out = []
    last = (len(rows) - 1) // every * every
    for i, views in enumerate(rows[:last + 1]):
        if i % every == 0 and binned:
            b = len(views) // prog.ranks
            with torch.no_grad():
                g = reference.gaussians(ts.params, ts.is_bezier, ts.alive, m, use_mask,
                                        config["optimization"]["mask_threshold"])
                for v in views[prog.rank * b:(prog.rank + 1) * b]:
                    pre = reference.project(g, cams.w2c[v], cams.proj[v], cams.height,
                                            cams.width, cams.tanfovx, cams.tanfovy)
                    gidx, counts, *_ = reference.bin_tiles(
                        pre, cams.height, cams.width, pipe["tile_capacity"],
                        pipe["big_capacity"])
                    out.append(dict(fields=reference.field_rows(pre), gidx=gidx, counts=counts,
                                    P=pre.mean2d.shape[0], height=cams.height,
                                    width=cams.width, step=i))
        if i < last:
            ts, _ = prog.chunk(ts, [views])
    return out


def prepare(cell: Cell, seed: int, device, group: Optional[RK.Group] = None):
    """The scene and population of `seed`, the program's state and its
    first three steps through the window's own chunk call, on views that
    all differ; returns (scene, population, program, initial state, the
    view order after those steps, what the comparison keeps of them)."""
    config, traffic = cell.config, cell.traffic
    B = traffic["views_per_step"]
    scene = SC.make_scene(config, device)
    pop = SC.population(config, traffic, scene, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prog = Program(config, traffic, scene, *((group.size, group.rank) if group else ()))
    ts0 = prog.init_state(pop)
    views = Views(scene.gts.shape[0], seed)
    rows = [views.take(B) for _ in range(3)]
    s1, m1 = prog.chunk(ts0, rows[:1])
    s3, m23 = prog.chunk(s1, rows[1:])
    first = dict(rows=rows, losses=torch.cat([m1["total"], m23["total"]]).tolist(),
                 mu1=prog.first_moments(s1), p3=prog.params(s3),
                 p0={k: v.detach().clone() for k, v in pop._asdict().items()})
    return scene, pop, prog, ts0, views, first


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, root: Path = ROOT,
        group: Optional[RK.Group] = None) -> Optional[dict]:
    """Set-up, the window and the comparison of one run; returns the
    result line's object (None on a rank other than 0, which leaves the
    group once the window and its trace are done)."""
    cuda = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    B, k = traffic["views_per_step"], traffic["chunk_steps"]
    N, rank = (group.size, group.rank) if group else (1, 0)
    scene, pop, prog, ts0, views, first = prepare(cell, seed, device, group)
    _host(prog.chunk(ts0, [views.take(B) for _ in range(k)])[1])  # the window's shape, warm
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    state, chunks, timings = ts0, 0, []
    bad = [0, 0]  # failed steps, of which not finite
    t0 = time.perf_counter()
    ends, calls = [t0], []
    while True:
        rows = [views.take(B) for _ in range(k)]
        if traced and cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, m = prog.chunk(state, rows)
            ev[1].record()
            timings.append(ev)
        else:
            out, m = prog.chunk(state, rows)
        calls.append(time.perf_counter())
        bad = [a + b for a, b in zip(bad, _bad_steps(_host(m)))]
        chunks += 1
        ends.append(time.perf_counter())
        state = ts0 if chunks % RESTART_CHUNKS == 0 else out
        done = time.perf_counter() - t0 >= seconds
        if group.decide(done) if group else done:
            break
    window_s = time.perf_counter() - t0
    steps = chunks * k
    if rank == 0:
        ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
        call = sorted(1e3 * (b - a) for a, b in zip(ends, calls))
        print(f"benchmark: {chunks} chunks of {k} steps, host ms a chunk min {ms[0]:.2f} "
              f"median {ms[len(ms) // 2]:.2f} max {ms[-1]:.2f}; in the chunk call (enqueue) "
              f"median {call[len(call) // 2]:.2f} max {call[-1]:.2f}", file=sys.stderr)
    traces = []
    if traced:  # one more chunk, profiled, after the window
        rows = [views.take(B) for _ in range(k)]
        traced_input = (state, rows)
        with TR.profiled(traces):
            out, m = prog.chunk(state, rows)
        bad = [a + b for a, b in zip(bad, _bad_steps(_host(m)))]
        steps += k
    del state, out, m

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics, extra, breakdown = {}, {}, None
    if traced:
        tr = traces[0]
        samples = count_samples(prog, *traced_input, COUNT_EVERY, config, traffic,
                                scene, binned=rank == 0)
        chunk_ms = [a.elapsed_time(b) for a, b in timings]
        if chunk_ms and rank == 0:
            print(f"benchmark: {len(chunk_ms)} chunks, device ms first {chunk_ms[:3]}, "
                  f"median {sorted(chunk_ms)[len(chunk_ms) // 2]}", file=sys.stderr)
        ctx = dict(trace=tr, traced_steps=k, views_per_step=B // N, samples=samples,
                   chunk_ms=chunk_ms, chunk_steps=k,
                   height=scene.cams.height, width=scene.cams.width)
        for mdef in cell.per_layer if rank == 0 else ():
            v = reader(mdef["name"], root)(ctx)
            if v is not None:
                metrics[mdef["name"]] = dict(value=v, unit=mdef["unit"])
        busy, span = TR.busy_seconds(tr), tr.window_s
        if group:  # averaged over the cards
            busy, span = (x / N for x in group.reduce([busy, span]))
        extra = dict(busy_s=busy, window_s=span)
        breakdown = dict(device_ops=TR.top_device_ops(tr), idle_gaps=TR.idle_gaps(tr))
        del samples, ctx, traced_input
    else:
        e2e = dict(train_views_per_s=steps * B / window_s, setup_s=setup_s)
        for mdef in cell.end_to_end:
            metrics[mdef["name"]] = dict(value=e2e[mdef["name"]], unit=mdef["unit"])
    prog.release()
    del prog, ts0
    if group:
        peak = group.reduce([peak], "max")[0]  # the fullest card's
        group.leave()
        if rank != 0:
            return None
    if cuda:
        torch.cuda.empty_cache()

    got = compare.gaps(compare.program_side(first),
                       compare.reference_side(config, traffic, scene, pop, first["rows"]))
    checks = {n: dict(value=got[n], limit=cell.limits[n]) for n in compare.NAMES}
    correct = bad[1] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    result = dict(correct=correct, attempted=steps * B, failed=bad[0] * B, metrics=metrics,
                  device=dict(platform="gpu" if cuda else device.type, count=cell.workload["chips"],
                              memory_peak_bytes=int(peak), **extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None, root: Path = ROOT, device: Optional[torch.device] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    cell = resolve(args.workload, root)
    chips = cell.workload["chips"]
    info = {}
    go = lambda dev, group=None: run(cell, args.seed, args.seconds, bool(args.trace),  # noqa
                                     dev, root, group)
    if device is not None:  # a CPU test: the look for a card skipped
        result = go(device)
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {cell.name} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    elif args.rank:  # a rank the command started: it prints nothing
        torch.set_num_threads(1)
        go(torch.device("cuda", args.rank), RK.join(chips, args.rank, args.port))
        return 0
    else:
        torch.set_num_threads(1)  # the host only launches: no pool of threads beside it
        info = card()
        print(f"benchmark: {info['kind']}, power limit {info['power_limit_w']} W, "
              f"{chips} card(s)", file=sys.stderr)
        if chips == 1:
            result = go(torch.device("cuda", 0))
        else:
            with RK.spawned("benchmark.run", argv, chips, root) as port:
                result = go(torch.device("cuda", 0), RK.join(chips, 0, port))
    result["device"].update(info)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: modules of JAX or the JAX package loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
