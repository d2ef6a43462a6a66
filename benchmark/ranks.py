"""A cell on more than one card: one process a rank, a card each, joined in
an NCCL process group over a localhost TCP rendezvous.

The command the driver starts is rank 0: it picks a free local port,
starts ranks 1..N-1 as processes of the same module with ``--rank`` and
``--port`` added, joins the group, and alone prints.  Each rank's standard
error goes to a temporary file (under ``TMPDIR``) that rank 0 shows when
the rank fails; rank 0 waits for every rank and ends them all when one
fails.  No tensor passes between processes outside the group.
"""
from __future__ import annotations

import contextlib
import datetime
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # the rendezvous and every collective
WAIT_S = 300  # the other ranks' end, once rank 0 is done


class Group(NamedTuple):
    size: int
    rank: int
    device: torch.device

    def decide(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank (a broadcast on the card)."""
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def reduce(self, values, op: str = "sum") -> list:
        """`values` (floats) summed ("sum") or maximised ("max") over the
        ranks."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return t.tolist()

    def leave(self) -> None:
        dist.barrier()
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(size: int, rank: int, port: int, device=None) -> Group:
    """This process as rank `rank` of `size`: on card `rank` over NCCL, or
    on `device` over gloo (a CPU rehearsal)."""
    kw = {}
    if device is None:
        device = kw["device_id"] = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if kw else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return Group(size, rank, torch.device(device))


@contextlib.contextmanager
def spawned(module: str, argv: list, size: int, cwd):
    """Start ranks 1..size-1 (``python -m module argv --rank r --port p``)
    and yield the port; on leaving, wait for them (ending them all if one
    fails or outlives ``WAIT_S``) and raise if one failed."""
    port = free_port()
    logs = [tempfile.TemporaryFile() for _ in range(size - 1)]
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r),
                               "--port", str(port)], cwd=cwd, stdout=subprocess.DEVNULL,
                              stderr=log) for r, log in zip(range(1, size), logs)]
    ok = False
    try:
        yield port
        ok = True
    finally:
        deadline = time.monotonic() + (WAIT_S if ok else 0)
        while ok and any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        bad = [(r, p.returncode) for r, p in zip(range(1, size), procs) if p.returncode != 0]
        tails = []
        for (r, code), log in zip(bad, [logs[r - 1] for r, _ in bad]):
            log.seek(0)
            tails.append(f"rank {r} exit {code}:\n{log.read().decode(errors='replace')[-3000:]}")
        for log in logs:
            log.close()
        if tails:
            print("\n".join(tails), file=sys.stderr)
        if ok and bad:
            raise RuntimeError(f"ranks {[r for r, _ in bad]} failed")
