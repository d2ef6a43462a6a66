"""The spans pass of a cell: the step's device milliseconds by module and the
device's idle between steps, read from the program's own device spans
(stamps of the device clock inside the captured step, switched on by
``StepGraphs.spans``), and what the stamps cost:

    python3 -m benchmark.spans --workload <cell> --seed <n> [--turns 10] [--warm 10]

After a run's set-up (``run.prepare`` and one warm-up chunk) and
``--warm`` seconds of window chunks (a process's first seconds on the card
run slower: the pass is meant to run after a run's window), ``spans_pass``
switches the spans on and runs ``SPANS_CHUNKS`` chunks of
the cell's ``chunk_steps`` from the state it is given, under the window's
rules (views popped by ``run.Views``, each chunk's metrics read back once),
then switches them off.  Then ``--turns`` turns of four chunks from the
phase's initial state over the same views, without spans, with, with,
without, each timed by CUDA events around its call as ``step_device_ms``
times the window's chunks: the difference is the stamps' cost.  Then the
pass once more (``after``: the card may have left its slow first phase).
One JSON line on standard output, with the card's name and power limit.

``run.py`` does not make this pass: a ``--trace 1`` run's readers would
take ``spans_pass``'s result from their context.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import sys
import time
from typing import Optional

import torch

from .run import RESTART_CHUNKS, _bad_steps, _host, card, prepare, resolve

SPANS_CHUNKS = 5  # one restart period of the window (run.RESTART_CHUNKS)


def spans_pass(prog, state, views, B: int, k: int, chunks: int = SPANS_CHUNKS) -> Optional[dict]:
    """`chunks` chunks of `k` steps of `B` views from `state` with the
    program's device spans on; returns {"ms": device ms a step by span,
    "step_ms": their sum, "idle_share": the device's idle between steps
    over the pass, "steps"}, or None where the program has no spans or a
    step's loss was not finite."""
    graphs = prog.graphs
    if not hasattr(graphs, "span_ms"):
        return None
    graphs.span_ms()  # what an earlier chunk left to sum, summed before
    graphs.span_totals = type(graphs.span_totals)()  # this pass's own sums
    nonfinite = 0
    graphs.spans = True
    try:
        for _ in range(chunks):
            state, m = prog.chunk(state, [views.take(B) for _ in range(k)])
            nonfinite += _bad_steps(_host(m))[1]
    finally:
        graphs.spans = False
    if nonfinite:
        print(f"benchmark: {nonfinite} steps of the spans pass with a loss that is not finite",
              file=sys.stderr)
        return None
    ms = graphs.span_ms()
    return dict(ms=ms, step_ms=sum(ms.values()), idle_share=graphs.idle_between_steps(),
                steps=graphs.span_totals.steps)


def clock(graphs) -> dict:
    """The device clock as the last chunk's stamps see it: the smallest
    nonzero difference between two of them (``min_ns``: no less than one
    stamp kernel and the node before it) and the greatest common divisor of
    their differences (``tick_ns``: the clock's step)."""
    names, table = graphs.last_stamps
    flat = sorted(table[:, : len(names) + 1].reshape(-1).tolist())
    steps = [b - a for a, b in zip(flat, flat[1:]) if b > a]
    return dict(min_ns=min(steps, default=None),
                tick_ns=functools.reduce(math.gcd, steps) if steps else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=10)
    p.add_argument("--warm", type=float, default=10.0, help="seconds of chunks before the pass")
    args = p.parse_args(argv)
    cell = resolve(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: the spans pass needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    info = card()
    B, k = cell.traffic["views_per_step"], cell.traffic["chunk_steps"]
    _, _, prog, ts0, views, _ = prepare(cell, args.seed, torch.device("cuda", 0))
    state, chunks, t0 = ts0, 0, time.perf_counter()
    while chunks == 0 or time.perf_counter() - t0 < args.warm:  # as a run's window
        out, m = prog.chunk(state, [views.take(B) for _ in range(k)])
        _host(m)
        chunks += 1
        state = ts0 if chunks % RESTART_CHUNKS == 0 else out
    got = spans_pass(prog, state, views, B, k)
    if got is None:
        print("benchmark: no device spans were read", file=sys.stderr)
        return 1
    got["clock"] = clock(prog.graphs)
    turns = []
    for _ in range(args.turns):
        rows = [views.take(B) for _ in range(k)]
        ms = []
        for on in (False, True, True, False):
            prog.graphs.spans = on
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, m = prog.chunk(ts0, rows)
            ev[1].record()
            _host(m)
            ms.append(ev[0].elapsed_time(ev[1]) / k)
        off, on = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        turns.append(dict(off_ms=off, on_ms=on, cost_share=(on - off) / off))
    prog.graphs.spans = False
    got["after"] = spans_pass(prog, state, views, B, k)
    prog.release()
    got["turns"] = turns
    got["cost_share_median"] = statistics.median(t["cost_share"] for t in turns)
    off_ms = statistics.median(t["off_ms"] for t in turns)
    print(f"benchmark: spans pass step ms {got['step_ms']!r} beside step_device_ms {off_ms!r} "
          f"(chunks without spans, median of {len(turns)} turns)", file=sys.stderr)
    print(json.dumps(dict(workload=cell.name, seed=args.seed, spans=got, device=info)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
