"""The readings that a cell's limits are set from (``limits/<cell>.json``),
on the card at the cell's own size, one process (a rank a card) for many
seeds:

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--fault exchange|half [--fault-in-reference]] [--no-control] [--out <file>]

For each seed it makes the run's set-up (``run.prepare``: the scene, the
population and the program's first three steps through the window's own
chunk call), frees the program, and prints one JSON line: the three
numbers of ``compare.py`` for the program against the plain reference
(``program``: over sound runs their largest is the lower reading) and for
the control, the reference computed in TF32 put in the program's place
(``control``: its smallest is the upper reading).  ``--fault`` plants a
fault in the program first, on every rank: ``exchange`` leaves the
exchange between the cards out, ``half`` leaves the views of the upper
half of the ranks out of the batch, the mean taken over the rest (a step
that returns its state unchanged reads 1 by construction and needs no
run).  With ``--fault-in-reference`` the fault is read on one card
with the reference put in the program's place (``reference_fault``).  No
window is measured: the numbers read only the first three steps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare, ranks as RK
from .run import forbidden_modules, prepare, resolve


def readings(cell, seed: int, device, group=None, control: bool = True) -> dict:
    t0 = time.perf_counter()
    scene, pop, prog, ts0, _, first = prepare(cell, seed, device, group)
    prog.release()
    del prog, ts0
    if group:
        group.decide(True)  # every rank's steps are done before rank 0 goes on alone
        if group.rank:
            return {}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    args = (cell.config, cell.traffic, scene, pop, first["rows"])
    ref = compare.reference_side(*args)
    t2 = time.perf_counter()
    out = dict(seed=seed, program=compare.gaps(compare.program_side(first), ref),
               losses=dict(program=first["losses"], reference=ref["losses"]),
               seconds=dict(setup=t1 - t0, reference=t2 - t1))
    if control:
        ctl = compare.reference_side(*args, mode="tf32")
        out["control"] = compare.gaps(ctl, ref)
        out["losses"]["control"] = ctl["losses"]
    return out


def reference_fault(cell, seed: int, device, fault: str) -> dict:
    """The fault read with the reference put in the program's place, on one
    card: the steps of `seed` (``run.prepare``'s views) with the exchange
    left out (rank 0's block of views alone, as a rank whose sums are not
    reduced updates from its own) or half of the batch left out (the mean
    over the first half of the views), against the sound reference."""
    from .run import Views
    from . import scene as SC

    config, traffic = cell.config, cell.traffic
    B, N = traffic["views_per_step"], cell.workload["chips"]
    scene = SC.make_scene(config, device)
    pop = SC.population(config, traffic, scene, seed, device)
    views = Views(scene.gts.shape[0], seed)
    rows = [views.take(B) for _ in range(3)]
    keep = {"exchange": B // N, "half": B // 2}[fault]
    ref = compare.reference_side(config, traffic, scene, pop, rows)
    bad = compare.reference_side(config, traffic, scene, pop, [r[:keep] for r in rows])
    return dict(seed=seed, fault=fault, program=compare.gaps(bad, ref))


def plant(fault: str, size: int, rank: int) -> None:
    """Break the program's B-view step on this rank (see the docstring)."""
    from curve_gaussian_tpu_torch.parallel import sharding as S

    if fault == "exchange":
        S._exchange = lambda bufs: None
    elif fault == "half":
        sums = S._rank_sums

        def half(*a, **kw):
            s, m = sums(*a, **kw)
            return (torch.zeros_like(s) if rank >= size // 2 else s), m

        S._rank_sums = half
    else:
        raise ValueError(f"fault {fault!r} is not 'exchange' or 'half'")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the readings of a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--no-control", action="store_true", help="the program's numbers alone")
    p.add_argument("--fault-in-reference", action="store_true",
                   help="read --fault with the reference in the program's place, on one card")
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    cell = resolve(args.workload)
    chips = 1 if args.fault_in_reference else cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("calibrate: not enough CUDA cards", file=sys.stderr)
        return 2
    if args.fault_in_reference:
        for seed in args.seeds:
            print(json.dumps(reference_fault(cell, seed, torch.device("cuda", 0), args.fault)),
                  flush=True)
        return 0
    if args.fault:
        plant(args.fault, chips, args.rank)
    if args.rank:
        group = RK.join(chips, args.rank, args.port)
        for seed in args.seeds:
            readings(cell, seed, group.device, group)
        group.leave()
        return 0
    lines = []

    def sweep(group=None):
        for seed in args.seeds:
            r = readings(cell, seed, torch.device("cuda", 0), group, not args.no_control)
            lines.append(r)
            print(json.dumps(r), flush=True)
        if group:
            group.leave()

    if chips == 1:
        sweep()
    else:
        with RK.spawned("benchmark.calibrate", argv, chips, None) as port:
            sweep(RK.join(chips, 0, port))
    summary = dict(workload=cell.name, seeds=args.seeds, fault=args.fault,
                   lower={n: max(r["program"][n] for r in lines) for n in compare.NAMES},
                   upper={n: min(r["control"][n] for r in lines) for n in compare.NAMES}
                   if not args.no_control else None,
                   forbidden=forbidden_modules())
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in lines + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
