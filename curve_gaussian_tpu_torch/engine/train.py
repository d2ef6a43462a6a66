"""Training step, TrainState and the eval render, as
``curve_gaussian_tpu/engine/train.py``.

One step = gaussians -> render (training configuration) -> total_loss ->
backward -> per-group Adam -> densification statistics.  With
``use_exposure`` the view's learned exposure (scale, offset) applies to the
render and its group is trained.  ``eval_render`` renders every channel of
the current state.  The training loop, with topology surgery and the
capacity policy, is ``engine/loop.py``.

A chunk of steps: ``train_steps_scan``, the counterpart of the JAX
package's ``lax.scan`` chunk, runs one step body that reads the state, the
view and the step's learning rates from tensors at fixed addresses and
writes the new state and the step's metrics back into them.  On CUDA
tensors it captures the body once per shape key as a CUDA graph
(``StepGraphs``) and replays it through the chunk, with no host work
between the replays; on CPU tensors it runs the same body eagerly.
``train_steps``, the eager loop of ``train_step`` calls, is the reference
it is held against.  The same body (``run_chunk``) takes B views a step
for ``parallel/sharding.py::parallel_train_steps_scan``: its tables hold
B stack rows a step, and the step function gets the B views stacked.  A
step whose ranks exchange sums (``StagedStep``, the B-view step over more
than one device) runs its collectives inside the body: on the card the
graph captures them (NCCL, a card per rank), on the CPU they run eagerly
(gloo).

The compiled render: ``eval_renders``, the counterpart of the JAX
package's jitted ``eval_render`` called once per view, renders many views
of one state through one body (``render_views``) that reads the state's
leaves, the view's row of camera stacks (by a device view counter) and
writes the render into its row of an output stack.  On CUDA tensors it
captures the body once per key as a CUDA graph (``RenderGraphs``) and
replays it once per view; on CPU tensors it runs the same body eagerly.
``eval_render``, the eager render of one view, is the reference it is held
against.  ``scripts/render_curves.py`` and
``parallel/sharding.py::tile_parallel_renders`` replay their frames
through the same body.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..models import curve_state as cs
from ..models import losses as L
from ..ops import binning_cuda, projection, rasterize_cuda, ssim_cuda, tile_blend_cuda
from ..ops.camera import Camera
from ..ops.projection import intrinsics
from ..ops.render import _flavor, render
from ..parallel import multihost
from . import graph_nodes, optim, spans
from .spans import Totals


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: optim.AdamState
    is_bezier: torch.Tensor  # [C] bool
    alive: torch.Tensor  # [C] bool
    xyz_grad_accum: torch.Tensor  # [C*M] accumulated |NDC grad| sums
    denom: torch.Tensor  # [C*M] visible counts
    max_radii: torch.Tensor  # [C*M] int32
    step: int
    opacity_frozen: bool


def init_train_state(state: cs.CurveState) -> TrainState:
    params = {k: v.clone() for k, v in cs.trainable(state).items()}
    n = state.capacity * state.n_gaussians
    ref = state.curve_points
    return TrainState(
        params=params,
        opt=optim.init_adam(params),
        is_bezier=state.is_bezier,
        alive=state.alive,
        xyz_grad_accum=torch.zeros((n,), dtype=ref.dtype, device=ref.device),
        denom=torch.zeros((n,), dtype=ref.dtype, device=ref.device),
        max_radii=torch.zeros((n,), dtype=torch.int32, device=ref.device),
        step=0,
        opacity_frozen=False,
    )


def dead_groups(use_exposure: bool = False):
    """Groups whose gradient is zero by construction in a step: the
    renderer forces ones colour, and the exposure enters the loss only with
    ``use_exposure``.  They skip the gradient and Adam entirely."""
    return ("features_dc",) + (() if use_exposure else ("exposure",))


def _exposure_row(exposure: torch.Tensor, view_idx) -> torch.Tensor:
    """Row `view_idx` of the exposure table; a tensor index selects it on
    the device (indexing with a 0-dim tensor reads it on the host)."""
    if torch.is_tensor(view_idx):
        return exposure.index_select(0, view_idx.reshape(1))[0]
    return exposure[view_idx]


def step_grads(
    ts: TrainState,
    cam: Camera,
    gt_image: torch.Tensor,
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    n_gaussians: int,
    conn_on: bool | None = None,
    view_idx: int | None = None,
    use_exposure: bool = False,
):
    """Loss and gradients of one step, without the update.

    Returns (loss, aux, grads, offset_grad, visible, radii, telemetry):
    grads holds the live groups only, offset_grad is d loss / d mean2d
    [C*M, 2] (pixel units), telemetry the binning counters.  With
    ``use_exposure`` the row ``view_idx`` (an int or a one-element tensor)
    of the exposure applies to the render, and the exposure group is
    live."""
    if use_exposure and view_idx is None:
        raise ValueError("use_exposure requires the step's view_idx")
    dead = dead_groups(use_exposure)
    live = {k: v.detach().requires_grad_(True) for k, v in ts.params.items()
            if k not in dead}
    params = {**{k: ts.params[k] for k in dead}, **live}
    state = cs.CurveState(**params, is_bezier=ts.is_bezier, alive=ts.alive)
    P = ts.alive.shape[0] * n_gaussians
    ref = ts.params["curve_points"]
    offset = torch.zeros((P, 2), dtype=ref.dtype, device=ref.device, requires_grad=True)
    with torch.enable_grad():
        gauss = cs.gaussians(state, use_mask=use_mask, mask_threshold=opt_cfg.mask_threshold)
        spans.on_grads([gauss[k] for k in ("xyz", "scale", "quat", "opacity")], "project")
        spans.mark("sample")
        out = render(
            gauss["xyz"], gauss["scale"], gauss["quat"], gauss["opacity"], cam,
            bg=bg, alive=gauss["alive"], mean2d_offset=offset,
            antialiasing=pipe_cfg.antialiasing,
            # the loss reads only the colour channel
            render_geo=False, compute_invdepth=False,
            capacity=pipe_cfg.tile_capacity, big_capacity=pipe_cfg.big_capacity,
            backend=pipe_cfg.backend,
            exposure=_exposure_row(params["exposure"], view_idx) if use_exposure else None,
        )
        loss, aux = L.total_loss(state, out, gauss, gt_image, opt_cfg, use_mask, conn_on=conn_on)
        spans.mark("loss")
        names = list(live)
        gs = torch.autograd.grad(loss, [live[k] for k in names] + [offset], allow_unused=True)
    spans.mark("sample")
    grads = {k: (g if g is not None else torch.zeros_like(live[k])) for k, g in zip(names, gs)}
    goffset = gs[-1] if gs[-1] is not None else torch.zeros_like(offset)
    visible = out["visibility"] & gauss["alive"]
    telemetry = {k: out[k] for k in ("overflow", "tile_peak", "big_peak", "big_overflow")}
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, grads, goffset, visible, out["radii"], telemetry


def update_state(ts: TrainState, grads, goffset: torch.Tensor, visible: torch.Tensor,
                 radii: torch.Tensor, opt_cfg: OptimizationConfig, size,
                 lr_row: Optional[torch.Tensor] = None) -> TrainState:
    """The update of one step from its gradients: per-group Adam at the
    rates of ``ts.step`` (or of ``lr_row``, see ``train_step``; a frozen
    opacity trains at rate 0) and the densification statistics of the
    screen-space gradient `goffset` of the `visible` Gaussians, on an image
    of `size` (height, width)."""
    if lr_row is None:
        lrs, bias = optim.group_lrs(opt_cfg, ts.step), None
    else:
        *rates, c1, c2 = lr_row.unbind()
        lrs, bias = dict(zip(optim.GROUPS, rates)), (c1, c2)
    if ts.opacity_frozen:
        lrs["opacity_raw"] = 0.0
    new_params, new_opt = optim.adam_update(ts.params, grads, ts.opt, lrs, bias)

    with torch.no_grad():
        # accumulated norm of the screen-space gradient of visible Gaussians,
        # in the reference's NDC * 0.5 * size units
        height, width = size
        ndc = torch.stack(
            [goffset[:, 0] * (0.5 * width), goffset[:, 1] * (0.5 * height)], dim=-1
        )
        gnorm = torch.linalg.vector_norm(ndc, dim=-1)
        vis_f = visible.to(gnorm.dtype)
        return TrainState(
            params=new_params,
            opt=new_opt,
            is_bezier=ts.is_bezier,
            alive=ts.alive,
            xyz_grad_accum=ts.xyz_grad_accum + gnorm * vis_f,
            denom=ts.denom + vis_f,
            max_radii=torch.maximum(ts.max_radii,
                                    torch.where(visible, radii, torch.zeros_like(radii))),
            step=ts.step + 1,
            opacity_frozen=ts.opacity_frozen,
        )


def train_step(
    ts: TrainState,
    cam: Camera,
    gt_image: torch.Tensor,
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    n_gaussians: int,
    conn_on: bool | None = None,
    view_idx: int | None = None,
    use_exposure: bool = False,
    lr_row: Optional[torch.Tensor] = None,
):
    """One training step; returns (new TrainState, metrics).  The input
    state is not modified.  ``lr_row``, a row of ``optim.lr_row`` on the
    device, gives the group rates and Adam's bias corrections in place of
    those of ``ts.step`` and ``ts.opt.count`` (a captured step must not bake
    host numbers in)."""
    _, aux, grads, goffset, visible, radii, telemetry = step_grads(
        ts, cam, gt_image, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians, conn_on=conn_on,
        view_idx=view_idx, use_exposure=use_exposure,
    )
    new_ts = update_state(ts, grads, goffset, visible, radii, opt_cfg,
                          (cam.height, cam.width), lr_row)
    metrics = dict(aux)
    metrics.update(telemetry)
    metrics["n_visible"] = visible.sum()
    return new_ts, metrics


def train_steps(
    ts: TrainState,
    cams: Sequence[Camera],
    gts: Sequence[torch.Tensor],
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    n_gaussians: int,
    conn_on: bool | None = None,
    view_indices: Sequence[int] | None = None,
    use_exposure: bool = False,
):
    """Run len(cams) steps in order; returns (state, list of metrics).
    ``view_indices`` gives each step's view (``use_exposure`` only)."""
    if use_exposure and view_indices is None:
        raise ValueError("use_exposure requires per-step view_indices")
    metrics: List[dict] = []
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        ts, m = train_step(ts, cam, gt, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians,
                           conn_on=conn_on, use_exposure=use_exposure,
                           view_idx=view_indices[i] if use_exposure else None)
        metrics.append(m)
    return ts, metrics


# the kernel wrappers, whose host counters count their launches
KERNEL_WRAPPERS = (
    projection.project_fwd, projection.project_bwd,
    binning_cuda.bin_tiles,
    rasterize_cuda.blend_train_fwd, rasterize_cuda.blend_train_bwd,
    rasterize_cuda.blend_train_bwd_basis, rasterize_cuda.reduce_slots,
    tile_blend_cuda.tile_blend_fwd,
    tile_blend_cuda.tile_blend_bwd, tile_blend_cuda.blend_moment_bwd,
    ssim_cuda.ssim_fwd, ssim_cuda.ssim_bwd,
)
# eager steps before a capture: each library's and wrapper's first-use
# set-up (kernel builds, the SSIM shared-memory limit and ticket, the
# Bezier bases on the device, the autograd and cuBLAS state of the stream)
# must happen outside the graph
WARMUP_STEPS = 1
MIN_CHUNK = 128  # rows of a graph's chunk tables: a longer chunk captures anew
_MAX_METRICS = 16  # columns of the metric rows (train_step returns up to 13)


def _launch_counts() -> Dict[str, int]:
    return {f.__name__: f.launches for f in KERNEL_WRAPPERS}


def camera_stacks(cameras: Sequence[Camera], dtype, device) -> tuple:
    """``train_steps_scan``'s camera stacks of `cameras` on `device`: w2c
    [V,4,4], proj [V,4,4], centres [V,3] and each view's intrinsics [V,4]
    in `dtype`, the state's."""
    stacks = tuple(torch.stack([getattr(c, f) for c in cameras]).to(device)
                   for f in ("world_to_cam", "full_proj", "cam_center"))
    rows = [intrinsics(c.height, c.width, c.tanfovx, c.tanfovy) for c in cameras]
    return stacks + (torch.tensor(rows, dtype=dtype, device=device),)


def _state_leaves(ts: TrainState) -> Dict[str, torch.Tensor]:
    """The tensors of a TrainState by name."""
    out = {}
    for prefix, d in (("params", ts.params), ("mu", ts.opt.mu), ("nu", ts.opt.nu)):
        out.update({f"{prefix}/{k}": v for k, v in d.items()})
    for k in ("is_bezier", "alive", "xyz_grad_accum", "denom", "max_radii"):
        out[k] = getattr(ts, k)
    return out


def _state_of(leaves: Dict[str, torch.Tensor], step: int, count: int,
              opacity_frozen: bool) -> TrainState:
    def group(prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in leaves.items() if k.startswith(prefix + "/")}

    return TrainState(
        params=group("params"),
        opt=optim.AdamState(mu=group("mu"), nu=group("nu"), count=count),
        is_bezier=leaves["is_bezier"], alive=leaves["alive"],
        xyz_grad_accum=leaves["xyz_grad_accum"], denom=leaves["denom"],
        max_radii=leaves["max_radii"], step=step, opacity_frozen=opacity_frozen,
    )


class _Buffers:
    """The tensors the step body reads and writes, at fixed addresses: the
    state, the view stacks (w2c, proj, centre, intrinsics, ground truth),
    the chunk's tables (the stack rows and exposure rows of each step's
    `views` views, [rows, views], and its learning-rate row), the number of
    active steps, the step counter, the metric rows and, made at the first
    chunk with device spans, the stamp table (``engine/spans.py``)."""

    def __init__(self, ts: TrainState, stacks, rows: int, views: int):
        dev = ts.alive.device
        self.state = {k: torch.empty_like(v) for k, v in _state_leaves(ts).items()}
        self.stacks = tuple(torch.empty_like(s) for s in stacks)
        i64 = dict(dtype=torch.int64, device=dev)
        self.rows = torch.zeros((rows, views), **i64)
        self.vix = torch.zeros((rows, views), **i64)
        self.lrs = torch.zeros((rows, len(optim.GROUPS) + 2),
                               dtype=ts.params["curve_points"].dtype, device=dev)
        self.n_active = torch.zeros(1, **i64)
        self.counter = torch.zeros(1, **i64)
        self.metrics = torch.zeros((rows, _MAX_METRICS), dtype=torch.float64, device=dev)
        self.stamps: Optional[torch.Tensor] = None

    def stamp_table(self) -> torch.Tensor:
        """The stamp table [rows, ``spans.columns(views)``] int64."""
        if self.stamps is None:
            rows, views = self.rows.shape
            self.stamps = torch.zeros((rows, spans.columns(views)), dtype=torch.int64,
                                      device=self.rows.device)
        return self.stamps

    def load(self, ts: TrainState, stacks, tables, n_active: int) -> None:
        """A chunk's inputs: the state and stacks by device copies, the
        tables (host tensors: rows, exposure rows, rates) in one copy each,
        and the counter at 0."""
        for k, v in _state_leaves(ts).items():
            self.state[k].copy_(v)
        for dst, src in zip(self.stacks, stacks):
            dst.copy_(src)
        for dst, src in zip((self.rows, self.vix, self.lrs), tables):
            if dst.is_cuda:  # pinned, so the copy neither waits nor blocks the host
                src = src.pin_memory()
            dst[: src.shape[0]].copy_(src, non_blocking=True)
        self.n_active.fill_(n_active)
        self.counter.zero_()


def _step_inputs(b: _Buffers, args: dict, step: int, count: int, opacity_frozen: bool):
    """The state, camera, ground truth and keyword arguments of step
    ``counter`` of the chunk: its views' rows of the stacks
    (``index_select`` on the device; with ``args["batched"]`` the views
    stacked, a Camera of [B] stacks, gts [B,H,W], exposure rows [B];
    otherwise its one view)."""
    h, w, tfx, tfy = args["cam_geom"]
    i = b.counter
    row = b.rows.index_select(0, i)[0]
    w2c, proj, ctr, intr, gt = (s.index_select(0, row) for s in b.stacks)
    if not args["batched"]:
        w2c, proj, ctr, intr, gt = w2c[0], proj[0], ctr[0], intr[0], gt[0]
    cam = Camera(world_to_cam=w2c, full_proj=proj, cam_center=ctr, height=h, width=w,
                 tanfovx=tfx, tanfovy=tfy, intrinsics=intr)
    kw = dict(use_mask=args["use_mask"], n_gaussians=args["n_gaussians"],
              conn_on=args["conn_on"],
              view_idx=b.vix.index_select(0, i)[0] if args["use_exposure"] else None,
              use_exposure=args["use_exposure"])
    return _state_of(b.state, step, count, opacity_frozen), cam, gt, kw


def _write_back(b: _Buffers, new: TrainState, m: dict) -> List[str]:
    """Write a step's new state (unless the step is at or past
    ``n_active``) and its metric row, and advance the counter; returns the
    metric names of the row.  The step's last device span stamp follows."""
    i = b.counter
    with torch.no_grad():
        act = i < b.n_active
        for k, v in _state_leaves(new).items():
            dst = b.state[k]
            if v is not dst:
                torch.where(act, v, dst, out=dst)
        names = list(m)
        if len(names) > _MAX_METRICS:
            raise ValueError(f"{len(names)} step metrics, more than {_MAX_METRICS}")
        vals = torch.stack([m[k].to(torch.float64) for k in names])
        b.metrics[:, : len(names)].index_copy_(0, i, vals[None])
        i.add_(1)
    spans.end("adam")
    return names


def _step_body(b: _Buffers, step_fn, args: dict, step: int, count: int,
               opacity_frozen: bool) -> List[str]:
    """One step from the buffers into the buffers; returns the metric names
    of its row.  Step ``counter`` of the chunk takes its views' rows of the
    stacks and its rows of the tables, writes the new state and its metric
    row, and advances the counter (``_step_inputs``, ``_write_back``).
    ``step`` and ``count`` are the host numbers of the state the step
    function sees: exact when the body runs eagerly, the capture's own in a
    graph, where nothing in the step reads them (the learning-rate row
    decides what they would).  The step's first device span stamp comes
    first."""
    spans.begin()
    state, cam, gt, kw = _step_inputs(b, args, step, count, opacity_frozen)
    new, m = step_fn(state, cam, gt, args["bg"], args["opt_cfg"], args["pipe_cfg"], **kw,
                     lr_row=b.lrs.index_select(0, b.counter)[0])
    return _write_back(b, new, m)


class StagedStep(NamedTuple):
    """A step whose ranks exchange sums between their local work and the
    update, in three stages: ``local`` takes a step function's arguments
    (without ``lr_row``) and returns the tensors to exchange, ``exchange``
    reduces them across the ranks in place, and ``update(ts, tensors,
    opt_cfg, (H, W), use_exposure, lr_row)`` returns (new TrainState,
    metrics).  Called, it runs the three in turn.  ``StepGraphs`` runs them
    as one body (``_fused_body``) and captures it as one graph, the
    collectives inside; the device spans stamp between the stages."""

    local: Callable
    exchange: Callable
    update: Callable

    def __call__(self, ts, cams, gts, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians=None,
                 conn_on=None, view_idx=None, use_exposure=False, lr_row=None):
        bufs = self.local(ts, cams, gts, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians,
                          conn_on=conn_on, view_idx=view_idx, use_exposure=use_exposure)
        self.exchange(bufs)
        return self.update(ts, bufs, opt_cfg, (cams.height, cams.width), use_exposure, lr_row)


def _stage_local(b: _Buffers, step: StagedStep, args: dict, stepno: int, count: int,
                 opacity_frozen: bool):
    """The local stage of step ``counter`` of the chunk: the tensors to
    exchange.  Its last device span stamp immediately precedes the
    exchange."""
    spans.begin()
    state, cam, gt, kw = _step_inputs(b, args, stepno, count, opacity_frozen)
    bufs = step.local(state, cam, gt, args["bg"], args["opt_cfg"], args["pipe_cfg"], **kw)
    spans.mark("adam")
    return bufs


def _stage_update(b: _Buffers, step: StagedStep, args: dict, bufs, stepno: int, count: int,
                  opacity_frozen: bool) -> List[str]:
    """The update stage of step ``counter`` from the reduced `bufs`,
    written back as ``_step_body`` writes a step.  Its first device span
    stamp immediately follows the exchange and closes its span."""
    spans.mark(spans.EXCHANGE)
    h, w, _, _ = args["cam_geom"]
    new, m = step.update(_state_of(b.state, stepno, count, opacity_frozen), bufs,
                         args["opt_cfg"], (h, w), args["use_exposure"],
                         b.lrs.index_select(0, b.counter)[0])
    return _write_back(b, new, m)


class _Graphs:
    """What ``StepGraphs`` and ``RenderGraphs`` share: the records of their
    captures, the memory pool and side stream of their graphs, and the
    capture itself.

    ``captures`` records each capture: what the caller put in it, the host
    seconds of its warm-up (to the end of its device work), capture and
    instantiation and their sum, the launches the kernel wrappers counted
    while it was captured, and its replays; a capture of collectives also
    the NCCL kernel nodes its graph holds (``nccl_kernels``).  The
    wrappers' counters are host counters: they count a captured launch once
    however often the graph replays it, and the warm-up's launches as eager
    ones."""

    def __init__(self):
        self.captures: List[dict] = []
        self._pool = self._stream = None

    @property
    def capture_seconds(self) -> float:
        return sum(c["seconds"] for c in self.captures)

    def captured_launches(self) -> Dict[str, int]:
        """Launches the wrappers counted inside captures, by wrapper."""
        out: Dict[str, int] = {}
        for c in self.captures:
            for k, n in c["launches"].items():
                out[k] = out.get(k, 0) + n
        return out

    def replayed_launches(self) -> Dict[str, int]:
        """Launches the graphs' replays made on the device, by wrapper."""
        out: Dict[str, int] = {}
        for c in self.captures:
            for k, n in c["launches"].items():
                out[k] = out.get(k, 0) + n * c["replays"]
        return out

    def _capture_body(self, dev, warm, body, load, record: dict,
                      collectives: bool = False):
        """Load the buffers (`load`, on the current stream), warm up on a
        side stream that waits for the current one (`warm`: the eager body),
        capture `body` there and instantiate it; returns (the graph, what
        `body` returned).  The caller restores the buffers that the warm-up
        advanced.  A capture that fails raises.
        ``capture_begin``/``capture_end`` in place of the
        ``torch.cuda.graph`` context, which empties the allocator's cache
        first: after the test renders that cache holds seconds of
        ``cudaFree``s, and the graph's pool needs none of it.

        With `collectives` the body holds NCCL collectives: each rank must
        have a card of its own (``multihost._check_nccl_cards``, which
        raises before any device work), the warm-up's eager ones have formed
        the communicator, the capture refuses unsafe calls from this thread
        only (NCCL's watchdog thread polls its events meanwhile), and the
        graph must hold NCCL kernels, or this raises."""
        if collectives:
            multihost._check_nccl_cards(multihost.local_ranks())
        t = [time.time()]
        with torch.cuda.device(dev):
            load()
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                warm()
                self._stream.synchronize()
                t.append(time.time())
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                before = _launch_counts()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                graph.capture_begin(pool=self._pool, capture_error_mode=(
                    "thread_local" if collectives else "global"))
                try:
                    result = body()
                finally:
                    graph.capture_end()
                after = _launch_counts()
                t.append(time.time())
                if collectives:
                    record["nccl_kernels"] = graph_nodes.nccl_kernels(graph)
                    if not record["nccl_kernels"]:
                        raise RuntimeError("a capture of collectives holds no NCCL kernel")
                graph.instantiate()
            torch.cuda.current_stream(dev).wait_stream(self._stream)
        t.append(time.time())
        record.update(seconds=t[3] - t[0], warmup_seconds=t[1] - t[0],
                      capture_seconds=t[2] - t[1], instantiate_seconds=t[3] - t[2], replays=0,
                      launches={k: n - before[k] for k, n in after.items() if n != before[k]})
        self.captures.append(record)
        return graph, result


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    names: List[str]  # the metric row's
    record: dict
    span_names: Optional[tuple] = None  # with spans: the spans its stamp columns 1.. close


class StepGraphs(_Graphs):
    """The CUDA graphs of ``train_steps_scan``: one captured step per shape
    key, all in one memory pool and over one set of buffers, and what
    capturing and replaying them cost.

    A caller keeps one for a run and passes it to every chunk, so that a
    shape key captures once.  The key is the sizes (state, stacks, views
    per step, configs, background, camera geometry, blend flavor) and the
    flags (mask, connectivity, exposure, frozen opacity).  New sizes drop
    every graph, the buffers and the pool: surgery and the capacity policy
    move forward, so the old sizes do not recur.  ``release`` drops them too
    and keeps the records.  ``step`` is the step function the body runs,
    ``train_step`` unless the caller wraps it or gives the view-batched
    step (``parallel/sharding.py::batch_step``, whose chunk is
    ``parallel_train_steps_scan``).

    A ``StagedStep`` (the B-view step of more than one rank, ``fuses``)
    runs its three stages as one body, the two collectives inside it: on
    the card one graph over NCCL, a card per rank, replayed through the
    chunk with nothing on the host between the replays (CUDA events around
    each chunk's replays add up their device time in ``fused_seconds`` over
    ``fused_steps``); on the CPU the same body eagerly over gloo.  A capture
    that fails raises.  The body counts the bytes its step exchanges
    (``exchange_bytes``, the SUM and MAX buffers of its last capture or
    eager step).

    With ``spans`` on, the step stamps its device spans (``engine/spans.py``)
    into the buffers' stamp table: a graph of its own (``spans`` is part of
    the key), in the same pool and over the same buffers as the graph
    without them, which it leaves in place.  Each chunk's table reaches the
    host in the sync that reads its metrics, and ``span_totals`` sums it:
    ``span_ms`` gives the device milliseconds a step by span,
    ``idle_between_steps`` the device's idle share between consecutive
    steps, and ``last_stamps`` holds the last chunk's table.  With
    ``spans`` off the step graph holds no stamp, and no table is made.

    ``captures`` records each capture (``_Graphs``) with its capacities,
    views and flags."""

    def __init__(self, step=None, spans: bool = False):
        super().__init__()
        self.step = step if step is not None else train_step
        self.exchange_bytes: Optional[int] = None
        self._fused_seconds = 0.0
        self._fused_steps = 0
        self._spans = bool(spans)
        self.span_totals = Totals()
        self.last_stamps: Optional[tuple] = None  # (the spans of its columns 1.., [k, C] table)
        # (event, fold, args) of each chunk whose timings or stamps are not summed
        # yet: ``fold(self, *args)`` once the event is done.  No entry refers to
        # this object or to a graph: a graph that held NCCL collectives and
        # outlived its last use in a reference cycle would block
        # ``destroy_process_group`` (NCCL waits for the graphs that captured
        # its collectives to be destroyed)
        self._pending: List[tuple] = []
        self._graphs: Dict[tuple, _Graph] = {}
        self._sizes = self._bufs = None

    def fuses(self) -> bool:
        """Whether the step is a ``StagedStep``: one body with its
        collectives inside (``_fused_body``)."""
        return isinstance(self.step, StagedStep)

    @property
    def spans(self) -> bool:
        """Whether the step stamps its device spans."""
        return self._spans

    @spans.setter
    def spans(self, on: bool) -> None:
        if bool(on) != self._spans:
            self.span_totals.pause()
        self._spans = bool(on)

    def _fold(self, wait: bool = True) -> None:
        """Sum the deferred chunks, in order: all of them, waiting for
        their events, or (`wait` False) those whose events are done."""
        while self._pending:
            event, fold, args = self._pending[0]
            if wait:
                event.synchronize()
            elif not event.query():
                return
            self._pending.pop(0)
            fold(self, *args)

    def _add_fused(self, start: "torch.cuda.Event", end: "torch.cuda.Event",
                   steps: int) -> None:
        self._fused_seconds += start.elapsed_time(end) / 1e3
        self._fused_steps += steps

    def _add_stamps(self, names: tuple, table: torch.Tensor) -> None:
        self.span_totals.add(table, names)
        self.last_stamps = (names, table)

    def span_ms(self) -> Dict[str, float]:
        """Device milliseconds a step by span over the chunks with spans;
        waits for the last of them."""
        self._fold()
        return self.span_totals.ms()

    def idle_between_steps(self) -> Optional[float]:
        """The device's idle share between consecutive steps with spans,
        or None where none ran; waits for the last of them."""
        self._fold()
        return self.span_totals.idle_share()

    @property
    def fused_steps(self) -> int:
        self._fold()
        return self._fused_steps

    @property
    def fused_seconds(self) -> float:
        """Device seconds of the fused graphs' replays (CUDA events around
        each chunk's replays); waits for the last of them."""
        self._fold()
        return self._fused_seconds

    @property
    def fused_step_ms(self) -> Optional[float]:
        """Device milliseconds a fused step, or None where none ran."""
        return self.fused_seconds / self.fused_steps * 1e3 if self.fused_steps else None

    def _fused_body(self, b: "_Buffers", args: dict, stepno: int, count: int,
                    opacity_frozen: bool) -> List[str]:
        """A ``StagedStep``'s three stages as one body: the local stage, the
        exchange and the update stage in turn; counts the bytes it
        exchanges."""
        bufs = _stage_local(b, self.step, args, stepno, count, opacity_frozen)
        self.exchange_bytes = sum(t.numel() * t.element_size() for t in bufs)
        self.step.exchange(bufs)
        return _stage_update(b, self.step, args, bufs, stepno, count, opacity_frozen)

    def eager_step(self, b: "_Buffers", args: dict, stepno: int, count: int,
                   opacity_frozen: bool) -> List[str]:
        """One step of the chunk eagerly, through the same body as its
        graph."""
        if self.fuses():
            return self._fused_body(b, args, stepno, count, opacity_frozen)
        return _step_body(b, self.step, args, stepno, count, opacity_frozen)

    @property
    def warmup_steps(self) -> int:
        return WARMUP_STEPS * len(self.captures)

    def latest_graph(self) -> "torch.cuda.CUDAGraph":
        """The graph captured last (kept with its ``cudaGraph_t``, so that
        its nodes can be read)."""
        return next(g.graph for g in self._graphs.values() if g.record is self.captures[-1])

    def release(self) -> None:
        self._graphs.clear()
        self._sizes = self._bufs = self._pool = None

    def _buffers(self, sizes: tuple, ts: TrainState, stacks, rows: int,
                 views: int) -> _Buffers:
        """The buffers of `sizes` with at least `rows` table rows of `views`
        views; new ones drop every graph (each reads the buffers it was
        captured with)."""
        if sizes != self._sizes or self._bufs.rows.shape[0] < rows:
            self.release()
            self._sizes = sizes
            self._bufs = _Buffers(ts, stacks, max(rows, MIN_CHUNK), views)
        return self._bufs

    def _capture(self, key: tuple, body, load, record: dict) -> _Graph:
        """``_capture_body`` of `body` (one eager step), with
        ``WARMUP_STEPS`` eager steps for the warm-up; `body` returns the
        metric names."""
        def warm_steps():
            for _ in range(WARMUP_STEPS):
                body()

        graph, names = self._capture_body(self._bufs.counter.device, warm_steps, body, load,
                                          record, collectives=self.fuses())
        self._graphs[key] = g = _Graph(graph, names, record)
        return g


def _host_ints(x, name: str, shape: tuple, bound: int) -> list:
    """`x` (a list, an array or a tensor) of `shape` as host ints in [0,
    `bound`), as nested lists; raises otherwise."""
    t = torch.as_tensor(x)
    flat = t.reshape(-1).tolist()
    if tuple(t.shape) != tuple(shape) or any(
            not (isinstance(v, int) and 0 <= v < bound) for v in flat):
        raise ValueError(f"{name} must hold {tuple(shape)} indices in [0, {bound}), "
                         f"got {t.tolist()}")
    return t.tolist()


def train_steps_scan(
    ts: TrainState,
    cam_arrays,  # (w2c [V,4,4], proj [V,4,4], centers [V,3][, intrinsics [V,4]])
    gts: torch.Tensor,  # [V, H, W]
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    n_gaussians: int,
    cam_geom,  # (H, W, tanfovx, tanfovy)
    conn_on: bool | None = None,
    n_active=None,
    view_indices=None,  # [k] ints (use_exposure only)
    use_exposure: bool = False,
    *,
    rows=None,
    graphs: Optional[StepGraphs] = None,
):
    """k training steps as one chunk, the counterpart of the JAX package's
    ``train_steps_scan``; returns (state, {metric: [k] float64}).

    Step i trains on row ``rows[i]`` of the stacks (row i when ``rows`` is
    None, the JAX function's per-step arrays: k = V); with ``use_exposure``
    it applies exposure row ``view_indices[i]``.  ``intrinsics``
    (``projection.intrinsics`` of each view) defaults to those of
    ``cam_geom`` for every row.  Steps at or past ``n_active`` leave the
    state as it is (their metrics are still computed).  The input state is
    not modified: a chunk copies it into the body's buffers and copies the
    result out.

    On CUDA tensors the step is captured once per shape key into a CUDA
    graph held by ``graphs`` (a new ``StepGraphs`` for this call when None)
    and replayed k times: the host copies the chunk's tables to the device
    once, then does nothing but replay.  On CPU tensors the same body runs
    k times eagerly, bitwise equal to ``train_steps`` over the same views."""
    if use_exposure and view_indices is None:
        raise ValueError("use_exposure requires per-step view_indices")
    V = gts.shape[0]
    rows = list(range(V)) if rows is None else _host_ints(rows, "rows", (len(rows),), V)
    vix = (_host_ints(view_indices, "view_indices", (len(rows),), ts.params["exposure"].shape[0])
           if use_exposure else [0] * len(rows))
    return run_chunk(ts, cam_arrays, gts, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians,
                     cam_geom, conn_on, n_active, [[r] for r in rows], [[v] for v in vix],
                     use_exposure, graphs if graphs is not None else StepGraphs(),
                     batched=False)


def run_chunk(ts: TrainState, cam_arrays, gts: torch.Tensor, bg, opt_cfg: OptimizationConfig,
              pipe_cfg: PipelineConfig, use_mask: bool, n_gaussians: int, cam_geom,
              conn_on, n_active, rows: List[List[int]], vix: List[List[int]],
              use_exposure: bool, graphs: StepGraphs, batched: bool):
    """The chunk of ``train_steps_scan`` and of
    ``parallel/sharding.py::parallel_train_steps_scan``: k steps of
    ``graphs.step``, step i over the B rows ``rows[i]`` of the stacks of all
    views (`cam_arrays`, `gts` [V,H,W]) with exposure rows ``vix[i]``
    (checked host ints, [k][B]), the views stacked when `batched`, else
    B = 1 and the step takes its view alone.  Returns (state, {metric: [k]
    float64})."""
    dev = gts.device
    dt = ts.params["curve_points"].dtype
    V = gts.shape[0]
    k = len(rows)
    if k < 1:
        raise ValueError("a chunk has at least one step")
    views = len(rows[0])
    n_act = k if n_active is None else max(0, min(int(n_active), k))
    if len(cam_arrays) == 3:
        cam_arrays = (*cam_arrays,
                      torch.tensor([intrinsics(*cam_geom)] * V, dtype=dt, device=dev))
    stacks = (*cam_arrays, gts)
    if any(s.shape[0] != V or s.device != dev for s in stacks):
        raise ValueError("the camera stacks and gts must have one row per view, on one device")
    with spans.host("chunk.tables"):
        tables = (torch.tensor(rows), torch.tensor(vix),
                  torch.tensor([optim.lr_row(opt_cfg, ts.step + i, ts.opt.count + i + 1)
                                for i in range(k)], dtype=dt))
    bg = float(bg)
    args = dict(bg=bg, opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, use_mask=use_mask,
                n_gaussians=n_gaussians, cam_geom=tuple(cam_geom), conn_on=conn_on,
                use_exposure=use_exposure, batched=batched)
    frozen = ts.opacity_frozen

    def recording(b: _Buffers):
        """The block's steps stamp their spans when they are on."""
        if not graphs.spans:
            return contextlib.nullcontext()
        return spans.recording(b.stamp_table(), b.counter)

    if dev.type != "cuda":
        with spans.host("chunk.load"):
            b = _Buffers(ts, stacks, k, views)
            b.load(ts, stacks, tables, n_act)
        seqs = set()
        with spans.host("chunk.replay"), recording(b) as rec:
            for i in range(k):
                j = min(i, n_act)
                names = graphs.eager_step(b, args, ts.step + j, ts.opt.count + j, frozen)
                if rec is not None:
                    seqs.add(rec.done)
        if rec is not None:
            if len(seqs) != 1:
                raise RuntimeError(f"the chunk's steps stamped different spans: {seqs}")
            graphs._add_stamps(seqs.pop(), b.stamps[:k].clone())
    else:
        graphs._fold(wait=False)
        sizes = (dev, tuple((n, v.shape, v.dtype) for n, v in _state_leaves(ts).items()),
                 tuple((s.shape, s.dtype) for s in stacks), views, batched, opt_cfg, pipe_cfg,
                 bg, tuple(cam_geom), _flavor())
        key = (use_mask, conn_on, use_exposure, frozen, graphs.spans)
        b = graphs._buffers(sizes, ts, stacks, k, views)
        g = graphs._graphs.get(key)
        if g is None:
            step0, count0 = ts.step, ts.opt.count
            with spans.host("chunk.capture"), recording(b) as rec:
                g = graphs._capture(
                    key, lambda: graphs.eager_step(b, args, step0, count0, frozen),
                    lambda: b.load(ts, stacks, tables, n_act),
                    dict(capacity=ts.alive.shape[0], tile_capacity=pipe_cfg.tile_capacity,
                         big_capacity=pipe_cfg.big_capacity, views=views, use_mask=use_mask,
                         conn_on=conn_on, use_exposure=use_exposure, spans=graphs.spans))
            g.span_names = rec.done if rec is not None else None
        with spans.host("chunk.load"):
            b.load(ts, stacks, tables, n_act)
        with spans.host("chunk.replay"):
            fused = graphs.fuses()
            if fused:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            for _ in range(k):
                g.graph.replay()
            if fused:
                end.record()
                graphs._pending.append((end, StepGraphs._add_fused, (start, end, k)))
        g.record["replays"] += k
        names = g.names
        if g.span_names is not None:
            # to the host in the sync that reads the metrics
            host = torch.empty((k, b.stamps.shape[1]), dtype=torch.int64, pin_memory=True)
            host.copy_(b.stamps[:k], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            graphs._pending.append((copied, StepGraphs._add_stamps, (g.span_names, host)))

    with spans.host("chunk.out"):
        out = {k_: v.clone() for k_, v in b.state.items()}
        out["is_bezier"], out["alive"] = ts.is_bezier, ts.alive
        vals = b.metrics[:k, : len(names)].clone()
    return (_state_of(out, ts.step + n_act, ts.opt.count + n_act, frozen),
            {name: vals[:, j] for j, name in enumerate(names)})


def _render_state(state: cs.CurveState, cam: Camera, pipe_cfg: PipelineConfig, bg,
                  use_mask: bool, mask_threshold: float, exposure=None) -> dict:
    """``render``'s dict of every channel of `state`'s Gaussians at `cam`:
    the body of ``eval_render`` and of each view of ``eval_renders``."""
    gauss = cs.gaussians(state, use_mask=use_mask, mask_threshold=mask_threshold)
    return render(
        gauss["xyz"], gauss["scale"], gauss["quat"], gauss["opacity"], cam,
        bg=bg, alive=gauss["alive"], antialiasing=pipe_cfg.antialiasing,
        render_geo=pipe_cfg.render_geo, capacity=pipe_cfg.tile_capacity,
        big_capacity=pipe_cfg.big_capacity, backend=pipe_cfg.backend, exposure=exposure,
    )


def eval_render(
    ts: TrainState,
    cam: Camera,
    pipe_cfg: PipelineConfig,
    bg,
    use_mask: bool = False,
    mask_threshold: float = 0.01,
    view_idx: int | None = None,
    use_exposure: bool = False,
):
    """The full-channel render of the current state (render, invdepth,
    alpha, dir and the rest of ``render``'s dict), with the pipeline
    config's ``render_geo``, capacities and backend, and the view's learned
    exposure when ``use_exposure``.  It stays differentiable; callers that
    only read the values wrap it in ``torch.no_grad()``.  The JAX function's
    ``n_gaussians`` has no counterpart: it is unused there too.  It runs
    eagerly; ``eval_renders`` is the same render of many views, captured as
    a CUDA graph on the card."""
    if use_exposure and view_idx is None:
        raise ValueError("use_exposure requires the view's train index")
    return _render_state(cs.curve_state_of(ts), cam, pipe_cfg, bg, use_mask, mask_threshold,
                         ts.params["exposure"][view_idx] if use_exposure else None)


# the maps ``eval_renders`` returns for the views its caller names
EVAL_MAPS = ("render", "invdepth", "alpha", "dir", "final_T")
# the state leaves an eval render reads (``cs.gaussians``)
_RENDER_LEAVES = ("curve_points", "opacity_raw", "width_raw", "mask_raw")


class _RenderBuffers:
    """The tensors a render body reads and writes, at fixed addresses: its
    inputs (state leaves or a Gaussian set, by name), the camera stacks
    (w2c, proj, centre, intrinsics), the stack rows of the views to render,
    the view counter and, for a stacked render, the output stack [n, H,
    W] (made by the first view, in its render's dtype)."""

    def __init__(self, inputs: Dict[str, torch.Tensor], stacks, n: int, stacked: bool):
        dev = stacks[0].device
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.stacks = tuple(torch.empty_like(s) for s in stacks)
        self.rows = torch.zeros(n, dtype=torch.int64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.stacked = stacked
        self.out: Optional[torch.Tensor] = None

    def load(self, inputs: Dict[str, torch.Tensor], stacks, views: List[int]) -> None:
        """A call's inputs and stacks by device copies, its rows in one copy,
        and the counter at 0."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        for dst, src in zip(self.stacks, stacks):
            dst.copy_(src)
        rows = torch.tensor(views, dtype=torch.int64)
        if self.rows.is_cuda:  # pinned, so the copy neither waits nor blocks the host
            rows = rows.pin_memory()
        self.rows.copy_(rows, non_blocking=True)
        self.counter.zero_()


def _render_view(b: _RenderBuffers, fn, geom) -> dict:
    """View ``counter`` of a call: the camera of its stack row (its
    projection from the row's intrinsics), ``fn(inputs, camera)``, the
    render written into its row of the output stack, and the counter
    advanced; returns fn's dict."""
    h, w, tfx, tfy = geom
    i = b.counter
    row = b.rows.index_select(0, i)
    w2c, proj, ctr, intr = (s.index_select(0, row)[0] for s in b.stacks)
    cam = Camera(world_to_cam=w2c, full_proj=proj, cam_center=ctr, height=h, width=w,
                 tanfovx=tfx, tanfovy=tfy, intrinsics=intr)
    with torch.no_grad():
        out = fn(b.inputs, cam)
        if b.stacked:
            if b.out is None:  # an eager first view: the warm-up of a capture
                b.out = out["render"].new_empty((b.rows.shape[0], *out["render"].shape))
            b.out.index_copy_(0, i, out["render"][None])
        i.add_(1)
    return out


def render_key(baked: tuple, inputs: Dict[str, torch.Tensor], stacks, geom, n: int) -> tuple:
    """The key of a render graph: (sizes, view group).  `baked` holds the
    host numbers the caller's render bakes into a capture (capacities,
    flags, background); the sizes add the device and the inputs' shapes
    and dtypes (a state's capacity and mask width); the view group is the
    views' geometry (H, W, tangents), the stacks' shapes and the number of
    views."""
    dev = stacks[0].device
    return ((baked, dev, tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())),
            (tuple(geom), tuple((tuple(s.shape), s.dtype) for s in stacks), n))


@dataclasses.dataclass
class _Render:
    bufs: _RenderBuffers
    graph: "torch.cuda.CUDAGraph"
    out: dict  # the captured body's outputs, rewritten by every replay
    record: dict


class RenderGraphs(_Graphs):
    """The CUDA graphs of ``render_views``: one captured render per key
    (``render_key``), replayed once per view, over buffers of its own and
    all in one memory pool, and what capturing and replaying them cost.

    A caller keeps one for a run (``engine/loop.py::train_scene``'s test
    renders, the frames of ``scripts/render_curves.py``) and passes it to
    every call, so that a key captures once.  Views of another geometry
    capture a render of their own beside the held ones; a key of other
    sizes (a state's capacity or mask width, a capacity of the pipeline, a
    flag, the background) drops every held render and the pool: surgery and
    the capacity policy move forward, so the old sizes do not recur.
    ``release`` drops them too and keeps the records (``_Graphs``: what
    the caller baked in, its views and image size)."""

    def __init__(self):
        super().__init__()
        self._held: Dict[tuple, _Render] = {}

    def release(self) -> None:
        self._held.clear()
        self._pool = None

    def latest(self) -> _Render:
        """The render captured last: its graph (kept with its
        ``cudaGraph_t``, so that its nodes can be read) and buffers."""
        return next(r for r in self._held.values() if r.record is self.captures[-1])

    def _lookup(self, key: tuple) -> Optional[_Render]:
        """The render held for `key`, or None; a key of other sizes than
        the held ones' drops them all first."""
        if any(k[0] != key[0] for k in self._held):
            self.release()
        return self._held.get(key)


def render_views(fn, inputs: Dict[str, torch.Tensor], stacks, geom, views, baked: tuple,
                 graphs: Optional[RenderGraphs] = None, stacked: bool = False,
                 collectives: bool = False):
    """Render the stack rows `views` one at a time, the counterpart of a
    jitted render called once per view; yields (buffers, fn's dict) after
    each view, in order.

    ``fn(inputs, camera)`` renders one view from the tensors `inputs` (a
    state's leaves or a Gaussian set, by name) and returns a dict; with
    `stacked` its ``"render"`` lands in row i of the buffers' output stack
    ``out`` [n, H, W].  `stacks` are the views' camera stacks (w2c, proj,
    centre, intrinsics; ``camera_stacks``) and `geom` their (H, W, tanfovx,
    tanfovy); each view's projection reads its row's intrinsics.  `baked`
    names every host number fn bakes into a capture beyond the shapes
    (``render_key``).

    On CUDA tensors the body (``_render_view``: the camera picked by a
    device counter, fn, the stack row) is captured once per key into a
    CUDA graph held by `graphs` (a new ``RenderGraphs`` for this call when
    None) and replayed once per view: the host copies the inputs, stacks
    and rows in once, then does nothing but replay.  The dict yielded is
    the graph's own output, rewritten by the next replay.  A capture that
    fails raises.  With `collectives` fn runs NCCL collectives, which the
    capture takes in (``_Graphs._capture_body``): every rank of the group
    must render the same views in the same order.  On CPU tensors the same
    body runs eagerly."""
    views = list(views)
    n, V = len(views), stacks[0].shape[0]
    if n < 1:
        raise ValueError("render_views renders at least one view")
    views = _host_ints(views, "views", (n,), V)
    dev = stacks[0].device
    if len(stacks) != 4 or any(s.shape[0] != V or s.device != dev for s in stacks) or any(
            v.device != dev for v in inputs.values()):
        raise ValueError("render_views needs the four camera stacks (w2c, proj, centre, "
                         "intrinsics) of one row per view and its inputs on one device")
    if dev.type != "cuda":
        b = _RenderBuffers(inputs, stacks, n, stacked)
        b.load(inputs, stacks, views)
        for _ in views:
            yield b, _render_view(b, fn, geom)
        return
    graphs = graphs if graphs is not None else RenderGraphs()
    key = render_key(baked, inputs, stacks, geom, n)
    r = graphs._lookup(key)
    if r is None:
        b = _RenderBuffers(inputs, stacks, n, stacked)
        record = dict(baked=baked, views=n, height=geom[0], width=geom[1])
        graph, out = graphs._capture_body(
            dev, lambda: _render_view(b, fn, geom), lambda: _render_view(b, fn, geom),
            lambda: b.load(inputs, stacks, views), record, collectives)
        r = graphs._held[key] = _Render(b, graph, out, record)
    r.bufs.load(inputs, stacks, views)
    for _ in views:
        r.graph.replay()
        r.record["replays"] += 1
        yield r.bufs, r.out


def _eval_baked(pipe_cfg: PipelineConfig, bg, use_mask: bool, mask_threshold: float) -> tuple:
    return ("eval_render", pipe_cfg.tile_capacity, pipe_cfg.big_capacity, pipe_cfg.render_geo,
            pipe_cfg.antialiasing, pipe_cfg.backend, bool(use_mask), float(mask_threshold),
            float(bg))


def _render_leaves(ts: TrainState) -> Dict[str, torch.Tensor]:
    out = {k: ts.params[k] for k in _RENDER_LEAVES}
    out.update(is_bezier=ts.is_bezier, alive=ts.alive)
    return out


def eval_render_key(ts: TrainState, cam_stacks, geom, pipe_cfg: PipelineConfig, bg,
                    n_views: int, use_mask: bool = False, mask_threshold: float = 0.01) -> tuple:
    """The ``render_key`` of an ``eval_renders`` call of `n_views` views."""
    return render_key(_eval_baked(pipe_cfg, bg, use_mask, mask_threshold), _render_leaves(ts),
                      cam_stacks, geom, n_views)


def eval_renders(
    ts: TrainState,
    cam_stacks,  # (w2c [V,4,4], proj [V,4,4], centers [V,3], intrinsics [V,4])
    geom,  # (H, W, tanfovx, tanfovy) of the views
    pipe_cfg: PipelineConfig,
    bg,
    views,  # stack rows to render
    *,
    use_mask: bool = False,
    mask_threshold: float = 0.01,
    graphs: Optional[RenderGraphs] = None,
    full=(),  # stack rows among `views` whose maps to return
):
    """``eval_render`` of the stack rows `views` (no gradient, no
    exposure), the counterpart of calling the JAX package's jitted
    ``eval_render`` once per view; returns (renders [n, H, W] on the
    state's device, {row: its ``EVAL_MAPS``} for each row in `full`).

    The state's leaves that ``cs.gaussians`` reads are copied in once per
    call, not once per view.  On CUDA tensors the render is one captured
    CUDA graph per key (``eval_render_key``) of `graphs`, replayed once per
    view; on CPU tensors the same body runs eagerly, bitwise equal to
    ``eval_render`` of each view."""
    views = list(views)
    full = set(_host_ints(list(full), "full", (len(full),), cam_stacks[0].shape[0]))
    if not full <= set(views):
        raise ValueError(f"full names rows {sorted(full - set(views))} outside views")

    def fn(leaves, cam):
        state = cs.CurveState(**{k: leaves[k] for k in _RENDER_LEAVES}, features_dc=None,
                              exposure=None, is_bezier=leaves["is_bezier"],
                              alive=leaves["alive"])
        return _render_state(state, cam, pipe_cfg, bg, use_mask, mask_threshold)

    maps = {}
    for v, (b, out) in zip(views, render_views(
            fn, _render_leaves(ts), cam_stacks, geom, views,
            _eval_baked(pipe_cfg, bg, use_mask, mask_threshold), graphs, stacked=True)):
        if v in full and v not in maps:
            maps[v] = {k: out[k].clone() for k in EVAL_MAPS}
    return b.out.clone(), maps
