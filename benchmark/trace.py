"""The traced window: ``torch.profiler`` over one chunk of a ``--trace 1`` run,
reduced to the device operations and host spans the per-layer readers
take.

Every event comes back as (name, start seconds, end seconds) on the
profiler's one clock.  Device events are the kernels, copies and fills
that CUPTI recorded (inside CUDA graph replays too); host events are the
CPU-side operations and the harness's own spans (``record_function``).
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import torch

Event = Tuple[str, float, float]
WINDOW_SPAN = "bench.window"


class Trace(NamedTuple):
    device: List[Event]  # kernels, copies and fills, by start
    kernels: List[Event]  # the kernels alone
    host: List[Event]
    window: Tuple[float, float]  # the traced window's span on the same clock

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    return str(kind()).lower() if kind is not None else ""


def _is_device(ev) -> bool:
    """A kernel, copy or fill on the card (not a user annotation, which the
    profiler mirrors onto the device's timeline)."""
    return (ev.device_type() == torch.autograd.DeviceType.CUDA
            and "annotation" not in _kind(ev) and ev.name() != WINDOW_SPAN)


def _is_kernel(ev) -> bool:
    kind = _kind(ev)
    if kind:
        return "kernel" in kind
    name = ev.name()
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


@contextlib.contextmanager
def profiled(out: list):
    """Profile the block (host and, with a card, device activity) inside a
    ``WINDOW_SPAN`` span; appends its ``Trace`` to `out` on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    device, kernels, host, window = [], [], [], None
    for ev in prof.profiler.kineto_results.events():
        e = (ev.name(), ev.start_ns() * 1e-9, (ev.start_ns() + ev.duration_ns()) * 1e-9)
        if _is_device(ev):
            device.append(e)
            if _is_kernel(ev):
                kernels.append(e)
        else:
            host.append(e)
            if e[0] == WINDOW_SPAN:
                window = (e[1], e[2])
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    inside = lambda evs: sorted((e for e in evs if e[2] > window[0] and e[1] < window[1]),  # noqa
                                key=lambda e: e[1])
    out.append(Trace(inside(device), inside(kernels), inside(host), window))


def busy_seconds(tr: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    busy, end = 0.0, tr.window[0]
    for _, s, e in tr.device:
        s, e = max(s, end), min(e, tr.window[1])
        if e > s:
            busy += e - s
            end = e
    return busy


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and its argument list, cut
    to `width` characters."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:width] or "(unnamed)"


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time."""
    total: dict = {}
    for name, s, e in tr.device:
        k = short_name(name)
        total[k] = total.get(k, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the n longest gaps with no
    device operation, each named by the innermost host event over its
    middle (the latest-starting one that covers it)."""
    gaps, end = [], tr.window[0]
    for _, s, e in tr.device:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if tr.window[1] > end:
        gaps.append((end, tr.window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = 0.5 * (s + e)
        cover = [h for h in tr.host if h[1] <= mid <= h[2]]
        what = max(cover, key=lambda h: h[1])[0] if cover else "outside any operation"
        out.append([f"host: {what}", e - s])
    return out
