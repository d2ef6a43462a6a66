"""Device spans: the training step's device time by module, read from the
program without a profiler, and the host ranges a profiler shows.

A step with spans on stamps the device's global nanosecond clock at the
boundaries of its modules into its row of a stamp table (one one-thread
kernel, ``csrc/spans.cu``, per stamp; the row is the step counter of the
step graph's buffers, as for its metric row).  ``begin`` stamps the step's
start; each ``mark(name)`` closes the interval since the previous stamp and
gives it to span `name`; ``end`` stamps the step's last node.  A span's
time in a step is the sum of the intervals given to it, so the spans tile
the step from its first node to its last.  The six spans (``SPANS``):

- ``sample``: the step's inputs and ``cs.gaussians``, forward and backward;
- ``project``: ``preprocess``, the ``mean2d`` offset and ``stack_fields``,
  forward and backward;
- ``bin``: ``bin_gaussians``;
- ``blend``: ``blend_train`` (K1, K2, the slot reduction, the moments to
  field gradients), or ``tile_blend`` under another flavor;
- ``loss``: the exposure, ``clip`` and ``total_loss`` (K7, K8), forward and
  backward;
- ``adam``: ``update_state``, the densification statistics, the metrics
  and the write-back (over more than one rank, the packing of the sums for
  the exchange too).

A step over more than one rank has a seventh, ``EXCHANGE``: from the stamp
immediately before its SUM collective to the one immediately after its MAX,
inside the step graph.  Each rank's collectives end only when every rank
has joined them, so the span holds the wait for the slowest rank, and its
spread across the ranks is their imbalance.

The backward boundaries are autograd tensor hooks registered in the forward
pass (``on_grad``, ``on_grads``), in the order autograd runs them: the
rendered image's gradient ends ``loss``'s backward, the field rows' ends
``blend``'s, the last of the Gaussians' (``xyz``, ``scale``, ``quat``,
``opacity``) ends ``project``'s, and the return of ``torch.autograd.grad``
ends ``sample``'s.  Backward terms that autograd runs between two such
boundaries stay with the interval they fall in.

Stamps are taken only inside ``recording`` (``engine/train.py::StepGraphs``
with ``spans`` on); elsewhere every call here returns at once.  On CPU
tensors a stamp is ``time.perf_counter_ns()``.  ``Totals`` folds a chunk's
table into device nanoseconds by span, the steps, and the device's idle
between consecutive steps.  ``host`` is a ``torch.profiler`` range of the
host's work (``chunk.*`` in ``run_chunk``, ``loop.*`` in ``train_scene``)
with its own host seconds; ``anchored`` puts a profiled chunk's stamps on
the profiler trace's clock by the stamp kernels it recorded.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import time
from typing import Dict, Optional, Sequence

import torch

from .. import _build

SPANS = ("sample", "project", "bin", "blend", "loss", "adam")
EXCHANGE = "exchange"  # the multi-rank step's collectives
KERNEL = "spans_stamp_kernel"  # the stamp kernel's name in a profiler trace


def columns(views: int) -> int:
    """Stamp columns a step of `views` views needs at most: its start, ten
    marks a view, two around the exchange and its end, with room to spare."""
    return 4 + 12 * views


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("spans")
    lib.spans_stamp.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.spans_stamp.restype = ctypes.c_int
    return lib


class _Recorder:
    """The stamp table [rows, columns] int64 and step counter of a
    recording, the column of the next stamp, and the spans of the current
    step's marks and of the last finished step's."""

    def __init__(self, table: torch.Tensor, counter: torch.Tensor):
        self.table, self.counter = table, counter
        self.col, self.names, self.done = 0, [], None

    def stamp(self, row_offset: int = 0) -> None:
        t = self.table
        if self.col >= t.shape[1]:
            raise RuntimeError(f"a step made more than {t.shape[1]} stamps")
        if t.is_cuda:
            lib = _lib()
            _build.check(lib, lib.spans_stamp(
                t.data_ptr(), self.counter.data_ptr(), t.shape[1], self.col, row_offset,
                torch.cuda.current_stream(t.device).cuda_stream), "spans_stamp")
        else:
            t[int(self.counter) + row_offset, self.col] = time.perf_counter_ns()


_active: Optional[_Recorder] = None  # global: autograd runs hooks on its own threads


@contextlib.contextmanager
def recording(table: torch.Tensor, counter: torch.Tensor):
    """Stamps on inside the block, into `table` at row ``counter``; yields
    the recorder, whose ``done`` holds the spans of the last finished
    step's marks."""
    global _active
    prev, _active = _active, _Recorder(table, counter)
    try:
        yield _active
    finally:
        _active = prev


def begin() -> None:
    """The step's first stamp (column 0)."""
    rec = _active
    if rec is not None:
        rec.col, rec.names = 0, []
        rec.stamp()


def mark(name: str) -> None:
    """Close the interval since the last stamp and give it to span `name`."""
    rec = _active
    if rec is not None:
        rec.col += 1
        rec.stamp()
        rec.names.append(name)


def end(name: str) -> None:
    """``mark(name)`` as the step's last stamp, after its counter advanced
    (so in the row before the counter's)."""
    rec = _active
    if rec is not None:
        rec.col += 1
        rec.stamp(row_offset=-1)
        rec.names.append(name)
        rec.done = tuple(rec.names)


def on_grad(t: torch.Tensor, name: str) -> None:
    """Mark `name` when the gradient of `t` is computed."""
    if _active is not None and t.requires_grad:
        t.register_hook(lambda _: mark(name))


def on_grads(tensors: Sequence[torch.Tensor], name: str) -> None:
    """Mark `name` when the last of the gradients of `tensors` is computed."""
    if _active is None:
        return
    live = [t for t in tensors if t.requires_grad]
    left = [len(live)]

    def hook(_):
        left[0] -= 1
        if left[0] == 0:
            mark(name)

    for t in live:
        t.register_hook(hook)


class Totals:
    """Running sums over the steps of chunks with spans: nanoseconds by
    span, the steps, the nanoseconds inside steps (each step's first to last
    stamp) and between consecutive steps (the device's idle there, across
    chunks too while the chunks follow each other with spans on)."""

    def __init__(self):
        self.ns: Dict[str, int] = {}
        self.steps = self.busy_ns = self.idle_ns = 0
        self._last: Optional[int] = None  # the last step's last stamp

    def add(self, table: torch.Tensor, names: Sequence[str]) -> None:
        """Fold a chunk's host table [k, >= len(names) + 1] of stamps, whose
        columns 1.. close the spans `names`."""
        n = len(names)
        t = table[:, : n + 1].to(torch.int64)
        d = t[:, 1:] - t[:, :-1]
        for j, name in enumerate(names):
            self.ns[name] = self.ns.get(name, 0) + int(d[:, j].sum())
        self.steps += t.shape[0]
        self.busy_ns += int((t[:, n] - t[:, 0]).sum())
        self.idle_ns += int((t[1:, 0] - t[:-1, n]).sum())
        if self._last is not None:
            self.idle_ns += int(t[0, 0]) - self._last
        self._last = int(t[-1, n])

    def pause(self) -> None:
        """The next chunk does not follow the last one directly: its gap is
        not idle between steps."""
        self._last = None

    def ms(self) -> Dict[str, float]:
        """Milliseconds a step by span, in ``SPANS`` order, then ``EXCHANGE``
        where the steps had one."""
        return {s: self.ns[s] / self.steps * 1e-6 for s in SPANS + (EXCHANGE,) if s in self.ns}

    def idle_share(self) -> Optional[float]:
        """The share of the device's time from the first step's start to
        the last step's end that lies between steps."""
        span = self.busy_ns + self.idle_ns
        return self.idle_ns / span if span else None


@contextlib.contextmanager
def host(name: str, seconds: Optional[dict] = None, key: Optional[str] = None):
    """A ``torch.profiler`` range `name` over the block; with `seconds`,
    its host seconds are added to ``seconds[key]``.  The range is an
    operator's (a ``cpu_op`` in the trace), not a user annotation: the
    profiler gives the kernels launched inside a user annotation to the
    innermost one, so a range of that kind would empty the device-side
    span of a caller's own annotation around a chunk."""
    t0 = time.perf_counter()
    with torch._C._profiler._RecordFunctionFast(name):
        yield
    if seconds is not None:
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def anchored(trace_path: str, names: Sequence[str], table: torch.Tensor) -> dict:
    """A profiled chunk's stamps (its host table [k, >= len(names) + 1])
    on the clock of the profiler trace at `trace_path`: the last stamp
    kernels the trace recorded are the table's stamps in order, and the
    median of their differences is the offset.  Returns (the spans each
    column closes, the offset in ns or None where the trace holds too few
    stamp kernels, the stamps in trace microseconds or None)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    starts = sorted(float(e["ts"]) for e in events
                    if e.get("cat") == "kernel" and KERNEL in e.get("name", ""))
    n = len(names) + 1
    rows = table[:, :n].tolist()
    flat = [s for row in rows for s in row]
    out = dict(marks=list(names), offset_ns=None, stamps_us=None)
    if flat and len(starts) >= len(flat):
        # in whole ns: a clock read since the epoch has more digits than a float holds
        diffs = sorted(round(1e3 * ts) - s for ts, s in zip(starts[-len(flat):], flat))
        off = diffs[len(diffs) // 2]
        out.update(offset_ns=off, stamps_us=[[(s + off) / 1e3 for s in row] for row in rows])
    return out
