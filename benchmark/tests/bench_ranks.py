"""One CPU rank of a tiny four-rank cell (gloo: the staged form of the
program's step), for ``test_bench_faults.py``:

    python3 bench_ranks.py <root> <rank> <port> [exchange|half]

Rank 0 prints the result line."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

import bench_tiny  # noqa: F401  (the repository on the path)
from benchmark import calibrate, ranks, run

if __name__ == "__main__":
    torch.set_num_threads(1)
    root, rank, port = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    if len(sys.argv) > 4:
        calibrate.plant(sys.argv[4], 4, rank)
    group = ranks.join(4, rank, port, torch.device("cpu"))
    res = run.run(run.resolve("tiny.views4", root), 77, 0.2, False, torch.device("cpu"), root,
                  group)
    if rank == 0:
        print(json.dumps(res))
