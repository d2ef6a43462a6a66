"""More than one device: the process group, as
``curve_gaussian_tpu/parallel/multihost.py``.

JAX drives the devices of a mesh from one process.  The port runs one
process per device (a rank), joined by a ``torch.distributed`` process
group: ``initialize_distributed`` joins this process to it,
``global_mesh`` is the port's mesh over it (``Mesh``: the group's size,
this rank and its device), and ``shard_scans`` deals scenes to processes
for sweeps that run one scene per process.

The group is described by ``CGT_NUM_PROCESSES``, ``CGT_COORDINATOR``
(``host:port`` or an ``init_method`` URL such as ``tcp://`` or ``file://``)
and ``CGT_PROCESS_ID``, or by torchrun's ``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.  The backend follows the device:
``nccl`` for CUDA, ``gloo`` for the CPU; a backend that cannot start
raises, and no other is tried.  NCCL takes one card per rank: rank r of a
host runs on ``cuda:LOCAL_RANK``, made the current device before NCCL
starts, and a group that asks NCCL for more ranks on a host than it has
cards raises.  A multi-rank step and a tile-parallel render capture the
collectives inside their CUDA graphs on the card, and run them eagerly on
the CPU.  Every collective and the rendezvous time out after
``TIMEOUT_S``.

``run_ranks`` starts the ranks of a group on this machine as processes and
waits for them with a deadline; a rank that fails or outlives it ends them
all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import subprocess
import tempfile
import time
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

TIMEOUT_S = 600  # the rendezvous and every collective


def _env_int(*names: str, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v:
            return int(v)
    return default


def group_size() -> int:
    """The ranks of the initialized process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_size() -> int:
    """The ranks of the initialized group, else those the environment
    describes (1 when it describes none)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("CGT_NUM_PROCESSES", "WORLD_SIZE", default=1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           timeout_s: float = TIMEOUT_S) -> int:
    """Join the process group (arguments first, then the environment) over
    the backend of `device`: NCCL for CUDA, gloo for the CPU; returns this
    process's rank.  A no-op returning 0 with one process, and returning
    the rank when the group is already initialized."""
    num = num_processes or _env_int("CGT_NUM_PROCESSES", "WORLD_SIZE", default=1)
    if num <= 1:
        return 0
    if dist.is_initialized():
        if dist.get_world_size() != num:
            raise RuntimeError(f"the initialized process group has {dist.get_world_size()} "
                               f"ranks, not {num}")
        return dist.get_rank()
    rank = process_id if process_id is not None else _env_int("CGT_PROCESS_ID", "RANK",
                                                              default=0)
    addr = coordinator_address or os.environ.get("CGT_COORDINATOR")
    if not addr and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not addr:
        raise RuntimeError(f"{num} processes but no coordinator: set CGT_COORDINATOR "
                           "(host:port or an init_method URL) or launch with torchrun")
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":  # NCCL, one card per rank, current before NCCL starts
        _check_nccl_cards(_env_int("LOCAL_WORLD_SIZE", default=num))
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK", default=rank))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev  # the communicator forms now, not at the first collective
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=num, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return rank


def local_ranks() -> int:
    """The initialized group's ranks on this host: torchrun's
    ``LOCAL_WORLD_SIZE``, else every rank (this package's launchers start a
    group on one host)."""
    return _env_int("LOCAL_WORLD_SIZE", default=group_size())


def _check_nccl_cards(ranks: int) -> None:
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise RuntimeError(
            f"NCCL takes one card per rank: {ranks} ranks on this host and {cards} CUDA "
            "card(s); launch at most one rank per card")


def nccl_version() -> str:
    """The version of the NCCL that PyTorch runs, as ``major.minor.patch``."""
    return ".".join(str(v) for v in torch.cuda.nccl.version())


def shard_scans(scans: Sequence[str], process_id: int, num_processes: int) -> List[str]:
    """Round-robin scene assignment for scene sweeps across processes."""
    return [s for i, s in enumerate(scans) if i % num_processes == process_id]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's device mesh: `size` ranks of the default process group,
    one device each, along one axis; this process is `rank` on `device`.
    Parameters are replicated; the views of a step are split in contiguous
    blocks (``block``), as ``P("data")`` splits them in the JAX package."""

    size: int
    rank: int
    device: torch.device
    axis: str = "data"

    @property
    def shape(self):
        """The ``mesh_shape`` of the functions that take one."""
        return ((self.axis, self.size),)

    def block(self, x):
        """This rank's contiguous block of the leading axis of `x` (a
        sequence or a tensor), which the mesh's size must divide."""
        n = len(x)
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        b = n // self.size
        return x[self.rank * b:(self.rank + 1) * b]


def check_ranks(n: int) -> int:
    """This process's rank in a group of `n`; raises unless the initialized
    group has `n` ranks (no group counts as one)."""
    world = group_size()
    if n != world:
        have = "no process group" if world == 1 else f"a process group of {world} ranks"
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} ranks and this process has {have}: launch {n} "
            f"processes, one per device: `torchrun --nproc-per-node {n} -m "
            f"curve_gaussian_tpu_torch.train --n-devices {n} ...`, or call "
            "parallel.multihost.initialize_distributed in each")
    return dist.get_rank() if n > 1 else 0


def group_mesh(n: int, axis: str = "data", device="cuda") -> Mesh:
    """The mesh of `n` ranks over the initialized group (``check_ranks``)."""
    return Mesh(size=n, rank=check_ranks(n), device=resolve_device(device), axis=axis)


def global_mesh(axis: str = "data", device="cuda") -> Mesh:
    """The mesh over every rank of the (possibly multi-host) group."""
    return group_mesh(group_size(), axis, device)


def rank_device(device="cuda") -> torch.device:
    """This rank's device for an entry point's ``--device``: a bare
    ``cuda`` is ``cuda:LOCAL_RANK`` when there is more than one process.  A
    named CUDA device is this rank's card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", "CGT_PROCESS_ID", "RANK", default=0))
    return dev


@contextlib.contextmanager
def distributed(device="cuda"):
    """An entry point's process group: yields this rank's device, after
    joining the group the environment describes when it describes more than
    one process (over the device's backend); a group this context
    initialized is destroyed on exit.  A CUDA device becomes the current
    one."""
    dev = rank_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    created = world_size() > 1 and not dist.is_initialized()
    if created:
        initialize_distributed(device=dev)
    try:
        yield dev
    finally:
        if created:
            dist.destroy_process_group()


class RankResult(NamedTuple):
    rank: int
    returncode: int
    output: str
    timed_out: bool
    seconds: float  # from the start to its exit, or to its kill


def run_ranks(commands: Sequence[Sequence[str]], timeout: float, env=None,
              cwd=None) -> List[RankResult]:
    """Run one process per rank (``commands[r]``) and wait for all of them,
    at most `timeout` seconds.  When one exits non-zero or the time is up,
    the others are killed (a rank left alone would wait in its next
    collective).  Returns each rank's exit code and its output (stdout and
    stderr), whether it was still running at the deadline, and its seconds;
    a killed process has a negative code."""
    files = [tempfile.TemporaryFile() for _ in commands]
    t0 = time.monotonic()
    procs = [subprocess.Popen(list(c), stdout=f, stderr=subprocess.STDOUT, env=env, cwd=cwd)
             for c, f in zip(commands, files)]
    deadline = t0 + timeout
    ends: List[Optional[float]] = [None] * len(procs)
    timed_out = False
    running = [False] * len(procs)

    def seen():
        for i, p in enumerate(procs):
            if ends[i] is None and p.poll() is not None:
                ends[i] = time.monotonic()

    try:
        while any(p.poll() is None for p in procs):
            seen()
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        seen()
        running = [p.poll() is None for p in procs]
        for p, alive in zip(procs, running):
            if alive:
                p.kill()
        for p in procs:
            p.wait()
        seen()
    out = []
    for r, (p, f) in enumerate(zip(procs, files)):
        f.seek(0)
        out.append(RankResult(r, p.returncode, f.read().decode(errors="replace"),
                              timed_out and running[r], ends[r] - t0))
        f.close()
    return out


def failures(results: Sequence[RankResult]) -> str:
    """The failed ranks of `run_ranks` with the end of their output, or ''."""
    bad = [r for r in results if r.returncode != 0 or r.timed_out]
    return "\n".join(f"rank {r.rank} {'timed out' if r.timed_out else f'exit {r.returncode}'} "
                     f"after {r.seconds:.1f} s:\n{r.output[-4000:]}" for r in bad)
