"""The view-batched training step and the tile-parallel render, as
``curve_gaussian_tpu/parallel/sharding.py``.

One optimizer step over a batch of B views: each view's loss and
gradients are computed from the same state (each view samples its own
Gaussians from the parameters, as the JAX scan does), summed in view order
from zeros and divided by B, so that a B-view step equals B reference
iterations' averaged gradient.  One Adam update and one update of the
densification statistics follow: ``gnorm`` from the mean screen-space
gradient, ``visible`` the OR and ``radii`` the max over the views, and
``step`` advances by 1.  The metrics are the JAX set: the mean ``total``,
the summed ``overflow`` and ``big_overflow``, the max ``tile_peak`` and
``n_visible``.  There is no ``big_peak`` and no per-term loss, so the
driver's big tier never shrinks on this path, in either package.

**More than one device.**  The JAX mesh of N devices is N ranks of a
``torch.distributed`` process group here, one process per device
(``multihost.py``; ``make_mesh`` is the mesh of the initialized group, and
a ``mesh_shape`` of N asks for a group of N ranks, or raises).  Every rank
holds the whole state; each passes its own contiguous block of the B views
(``Mesh.block``, what ``P("data")`` gives each device), sums its views'
gradients, and exchanges the sums in two collectives a step: SUM of one
flat buffer (the gradients, the screen-space gradient, the loss, the
overflow counts, the visibility as counts and the views, which sum to
``nglobal = nb * N``) and MAX of a second (the radii and the tile peak).
Counts ride in the state's float dtype, exact below 2**24.  Every rank then
runs the same Adam and statistics update on the same reduced values.  At
one device the sums go straight to the update, as the JAX function skips
its collectives there.

On CUDA tensors ``parallel_train_steps_scan`` captures the whole B-view
step as one CUDA graph per shape key and replays it through the chunk
(``engine/train.py::StepGraphs``).  At more than one device (NCCL, a card
per rank) the two collectives are captured inside it between the local
sums and the update: the counterpart of the JAX package's one compiled
data-parallel chunk.  On CPU tensors the same body runs eagerly (gloo).

``tile_parallel_render`` renders one view with its tile rows split across
the ranks: each bins and blends (K3) only its band of rows, and the bands
are summed into the full image on every rank.  ``tile_parallel_renders``,
the counterpart of the JAX ``render_tp`` jit of ``render_curves
--n-devices``, renders many views of one Gaussian set so: on CUDA tensors
each rank's band, the sum inside it, is one captured CUDA graph per key
(``engine/train.py::render_views``) replayed once per view.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import OptimizationConfig, PipelineConfig
from ..engine import train as T
from ..engine.train import StagedStep, StepGraphs, TrainState
from ..models import curve_state as cs
from ..ops.binning import bin_gaussians, tile_grid
from ..ops.camera import Camera, index_camera, stack_cameras
from ..ops.projection import preprocess
from ..ops.rasterize_cuda import stack_fields
from ..ops.rasterize_ref import TILE_H
from ..ops.render import main_axis_allmap
from ..ops.tile_blend_cuda import tile_blend_fwd
from .multihost import Mesh, check_ranks, group_mesh, group_size


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device="cuda") -> Mesh:
    """The mesh of the initialized process group (of one device without a
    group); raises unless the group has `n_devices` ranks."""
    return group_mesh(n_devices or group_size(), axis, device)


def _mesh_ranks(mesh_shape) -> Tuple[int, int]:
    """(N, this rank) of ``mesh_shape`` (None: this process alone); raises
    unless the process group has N ranks."""
    if mesh_shape is None:
        return 1, 0
    shape = dict(mesh_shape)
    if set(shape) != {"data"}:
        raise ValueError(f"mesh_shape {mesh_shape!r} has no single 'data' axis")
    n = int(shape["data"])
    return n, check_ranks(n)


def batch_cameras(cams: Sequence[Camera]) -> Camera:
    return stack_cameras(list(cams))


def camera_batch_arrays(cams: Sequence[Camera], mesh: Optional[Mesh] = None):
    """Stack per-view camera arrays (w2c [B,4,4], proj [B,4,4], centres
    [B,3]); with a `mesh`, of this rank's block of the views, on its
    device."""
    cams = list(cams)
    if mesh is not None:
        cams = mesh.block(cams)
    out = tuple(torch.stack([getattr(c, f) for c in cams])
                for f in ("world_to_cam", "full_proj", "cam_center"))
    return out if mesh is None else tuple(a.to(mesh.device) for a in out)


def _one_view_grads(ts: TrainState, cam: Camera, gt: torch.Tensor, bg,
                    opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig, use_mask: bool,
                    n_gaussians: int, conn_on: bool | None = None, view_idx=None,
                    use_exposure: bool = False):
    """One view's gradients of the live groups and of the screen-space
    offset, its loss and its binning counters: (grads, offset_grad, total,
    visible, radii, overflow, tile_peak, big_overflow)."""
    _, aux, grads, goff, visible, radii, tele = T.step_grads(
        ts, cam, gt, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians, conn_on=conn_on,
        view_idx=view_idx, use_exposure=use_exposure)
    return (grads, goff, aux["total"], visible, radii, tele["overflow"], tele["tile_peak"],
            tele["big_overflow"])


def _view_sums(ts: TrainState, cams: Camera, gts: torch.Tensor, bg,
               opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig, use_mask: bool,
               n_gaussians: Optional[int] = None, conn_on: bool | None = None,
               view_idx=None, use_exposure: bool = False):
    """The sums over this process's B views, from zeros in view order:
    (grads, offset_grad, total, visible (OR), radii (max), overflow,
    tile_peak (max), big_overflow)."""
    if use_exposure and view_idx is None:
        raise ValueError("use_exposure requires per-view train indices")
    if n_gaussians is None:
        n_gaussians = ts.params["mask_raw"].shape[1]
    acc = None
    for v in range(gts.shape[0]):
        out = _one_view_grads(ts, index_camera(cams, v), gts[v], bg, opt_cfg, pipe_cfg,
                              use_mask, n_gaussians, conn_on=conn_on,
                              view_idx=view_idx[v] if use_exposure else None,
                              use_exposure=use_exposure)
        if acc is None:  # zeros, as the JAX scan's carry starts
            acc = ({k: torch.zeros_like(g) for k, g in out[0].items()},
                   *(torch.zeros_like(x) for x in out[1:]))
        gp, goff, tot, vis, rad, ov, peak, big_ov = acc
        acc = ({k: gp[k] + g for k, g in out[0].items()}, goff + out[1], tot + out[2],
               vis | out[3], torch.maximum(rad, out[4]), ov + out[5],
               torch.maximum(peak, out[6]), big_ov + out[7])
    return acc


def _update(ts: TrainState, acc, nglobal, opt_cfg: OptimizationConfig, size,
            lr_row: Optional[torch.Tensor]):
    """Adam and the statistics from the sums `acc` over `nglobal` views."""
    gp, goff, tot, vis, rad, ov, peak, big_ov = acc
    gp = {k: g / nglobal for k, g in gp.items()}
    new_ts = T.update_state(ts, gp, goff / nglobal, vis, rad, opt_cfg, size, lr_row)
    metrics = {
        "total": tot / nglobal,
        "overflow": ov,
        "n_visible": vis.sum(),
        "tile_peak": peak,
        "big_overflow": big_ov,
    }
    return new_ts, metrics


def _local_batch_step(ts: TrainState, cams: Camera, gts: torch.Tensor, bg,
                      opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig, use_mask: bool,
                      n_gaussians: Optional[int] = None, conn_on: bool | None = None,
                      view_idx=None, use_exposure: bool = False,
                      lr_row: Optional[torch.Tensor] = None):
    """One optimizer step over B views on one device; returns (new
    TrainState, metrics).  `cams` holds the views stacked (``[B]`` leading
    axes, intrinsics too when set), `gts` [B,H,W] and, with
    ``use_exposure``, `view_idx` [B] the views' exposure rows.  The keyword
    arguments are ``train_step``'s (``lr_row`` as there), so that
    ``StepGraphs`` runs it as the step function of a chunk; `n_gaussians`
    defaults to the state's."""
    acc = _view_sums(ts, cams, gts, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians,
                     conn_on=conn_on, view_idx=view_idx, use_exposure=use_exposure)
    return _update(ts, acc, gts.shape[0], opt_cfg, (cams.height, cams.width), lr_row)


def _rank_sums(ts: TrainState, cams: Camera, gts: torch.Tensor, bg,
               opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig, use_mask: bool,
               n_gaussians: Optional[int] = None, conn_on: bool | None = None,
               view_idx=None, use_exposure: bool = False):
    """This rank's sums packed for the exchange: (SUM buffer, MAX buffer)
    in the state's dtype (the layout ``_unpack`` reads)."""
    gp, goff, tot, vis, rad, ov, peak, big_ov = _view_sums(
        ts, cams, gts, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians, conn_on=conn_on,
        view_idx=view_idx, use_exposure=use_exposure)
    dt = goff.dtype
    sums = torch.cat([*(g.reshape(-1) for g in gp.values()), goff.reshape(-1),
                      tot.reshape(1).to(dt), vis.to(dt), ov.reshape(1).to(dt),
                      big_ov.reshape(1).to(dt),
                      torch.full((1,), gts.shape[0], dtype=dt, device=goff.device)])
    maxes = torch.cat([rad.to(dt), peak.reshape(1).to(dt)])
    return sums, maxes


def _exchange(bufs) -> None:
    """The step's two collectives over the default group, in place: SUM,
    then MAX.  Synchronous on the current stream, so that a capture of the
    step takes them in."""
    dist.all_reduce(bufs[0], op=dist.ReduceOp.SUM)
    dist.all_reduce(bufs[1], op=dist.ReduceOp.MAX)


def _unpack(ts: TrainState, bufs, use_exposure: bool):
    """The reduced sums of ``_rank_sums``' buffers, as ``_view_sums``
    returns them, and ``nglobal``."""
    sums, maxes = bufs
    live = [k for k in ts.params if k not in T.dead_groups(use_exposure)]
    P = ts.max_radii.shape[0]
    sizes = [ts.params[k].numel() for k in live] + [2 * P, 1, P, 1, 1, 1]
    parts = torch.split(sums, sizes)
    gp = {k: p.view(ts.params[k].shape) for k, p in zip(live, parts)}
    goff, tot, vis, ov, big_ov, nglobal = parts[len(live):]
    i32 = torch.int32
    acc = (gp, goff.view(P, 2), tot[0], vis > 0, maxes[:P].to(i32), ov[0].to(i32),
           maxes[P].to(i32), big_ov[0].to(i32))
    return acc, nglobal[0]


def _reduced_update(ts: TrainState, bufs, opt_cfg: OptimizationConfig, size,
                    use_exposure: bool, lr_row: Optional[torch.Tensor] = None):
    acc, nglobal = _unpack(ts, bufs, use_exposure)
    return _update(ts, acc, nglobal, opt_cfg, size, lr_row)


def batch_step(n_ranks: int):
    """The B-view step function of a mesh of `n_ranks`: ``_local_batch_step``
    at one; at more, a ``StagedStep`` (local sums, exchange, update), which
    ``StepGraphs`` runs as one body, its collectives inside."""
    if n_ranks == 1:
        return _local_batch_step
    return StagedStep(local=_rank_sums, exchange=_exchange, update=_reduced_update)


def _batch_camera(cam_arrays, cam_geom) -> Camera:
    h, w, tfx, tfy = cam_geom
    return Camera(world_to_cam=cam_arrays[0], full_proj=cam_arrays[1],
                  cam_center=cam_arrays[2], height=h, width=w, tanfovx=tfx, tanfovy=tfy,
                  intrinsics=cam_arrays[3] if len(cam_arrays) == 4 else None)


def parallel_train_step(
    ts: TrainState,
    cam_arrays,  # (w2c [b,4,4], proj [b,4,4], centers [b,3][, intrinsics [b,4]]): this rank's
    gts: torch.Tensor,  # [b, H, W]: this rank's
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]],
    cam_geom: Tuple[int, int, float, float],
    conn_on: bool | None = None,
    view_indices=None,  # [b] ints (use_exposure)
    use_exposure: bool = False,
):
    """One step over a B-view batch, eagerly; returns (new TrainState,
    metrics).  Each of the N ranks of ``mesh_shape`` passes its block of b
    = B/N views; the result is the same on every rank.  The input state is
    not modified."""
    n, _ = _mesh_ranks(mesh_shape)
    if use_exposure and view_indices is None:
        raise ValueError("use_exposure requires per-view train indices")
    return batch_step(n)(ts, _batch_camera(cam_arrays, cam_geom), gts, bg, opt_cfg, pipe_cfg,
                         use_mask, conn_on=conn_on, view_idx=view_indices,
                         use_exposure=use_exposure)


def parallel_train_steps_scan(
    ts: TrainState,
    cam_arrays,  # (w2c [K,b,4,4], proj [K,b,4,4], centers [K,b,3]), or [V,...] with rows
    gts: torch.Tensor,  # [K, b, H, W], or [V, H, W] with rows
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]],
    cam_geom: Tuple[int, int, float, float],
    conn_on: bool | None = None,
    n_active=None,
    view_indices=None,  # [K, b] ints (use_exposure)
    use_exposure: bool = False,
    *,
    rows=None,
    graphs: Optional[StepGraphs] = None,
):
    """K steps of B views each as one chunk; returns (state, {metric: [K]
    float64}).  Each of the N ranks of ``mesh_shape`` passes its b = B/N
    views of every step (its columns of the [K, B] table: ``Mesh.block`` of
    each row).

    Without ``rows``, step i takes the b views ``cam_arrays[:, ...][i]``
    and ``gts[i]``, the JAX function's per-step arrays.  With ``rows``, a
    [K, b] table, `cam_arrays` (intrinsics [V,4] optional) and `gts` are
    stacks of all V views and step i takes the rows ``rows[i]``, as the
    driver gives them.  ``view_indices`` [K, b] are the views' exposure
    rows.  Steps at or past ``n_active`` leave the state as it is.  On CUDA
    tensors the step is captured per shape key into graphs of ``graphs`` (a
    ``StepGraphs`` of ``batch_step(N)``, new for this call when None) and
    replayed K times; a capture that fails raises.  On CPU tensors the same
    bodies run eagerly, bitwise equal to K calls of
    ``parallel_train_step``."""
    n, _ = _mesh_ranks(mesh_shape)
    if use_exposure and view_indices is None:
        raise ValueError("use_exposure requires per-step view_indices")
    if rows is None:
        K, B = gts.shape[:2]
        cam_arrays = tuple(a.reshape(K * B, *a.shape[2:]) for a in cam_arrays)
        gts = gts.reshape(K * B, *gts.shape[2:])
        rows = [[i * B + j for j in range(B)] for i in range(K)]
    else:
        shape = tuple(torch.as_tensor(rows).shape)
        if len(shape) != 2:
            raise ValueError(f"rows must be a [K, B] table, got shape {shape}")
        rows = T._host_ints(rows, "rows", shape, gts.shape[0])
    shape = (len(rows), len(rows[0]) if rows else 0)
    vix = (T._host_ints(view_indices, "view_indices", shape, ts.params["exposure"].shape[0])
           if use_exposure else [[0] * shape[1] for _ in rows])
    return T.run_chunk(ts, cam_arrays, gts, bg, opt_cfg, pipe_cfg, use_mask,
                       ts.params["mask_raw"].shape[1], cam_geom, conn_on, n_active, rows, vix,
                       use_exposure, graphs if graphs is not None else StepGraphs(batch_step(n)),
                       batched=True)


def tile_parallel_render(
    ts: TrainState,
    cam_arrays,  # (w2c [4,4], proj [4,4], center [3])
    cam_geom: Tuple[int, int, float, float],
    pipe_cfg: PipelineConfig,
    bg,
    mesh_shape: Tuple[Tuple[str, int], ...],
    n_gaussians: int = 12,
):
    """One view's render [H, W] with the image's tile rows split across the
    ranks of ``mesh_shape`` (every rank returns the whole image).  The JAX
    function's ``n_gaussians`` is the state's here, unused as there."""
    H, W, tfx, tfy = cam_geom
    cam = Camera(world_to_cam=cam_arrays[0], full_proj=cam_arrays[1],
                 cam_center=cam_arrays[2], height=H, width=W, tanfovx=tfx, tanfovy=tfy)
    with torch.no_grad():
        gauss = cs.gaussians(cs.curve_state_of(ts))
    return tile_parallel_render_gaussians(gauss, cam, pipe_cfg, bg, mesh_shape)


@torch.no_grad()
def tile_parallel_render_gaussians(gauss: dict, cam: Camera, pipe_cfg: PipelineConfig, bg,
                                   mesh_shape: Tuple[Tuple[str, int], ...]) -> torch.Tensor:
    """``tile_parallel_render`` of a Gaussian set (xyz, scale, quat,
    opacity [, alive]): the core shared by state renders and
    ``tile_parallel_renders``.  Every rank renders its band
    (``_band_image``); the bands are summed across the ranks (exact), then
    cropped at H."""
    n, rank = _mesh_ranks(mesh_shape)
    return _sum_bands(_band_image(gauss, cam, pipe_cfg, bg, n, rank), n, cam.height)


def _sum_bands(img: torch.Tensor, n: int, H: int) -> torch.Tensor:
    if n > 1:
        dist.all_reduce(img, op=dist.ReduceOp.SUM)
    return img[:H]


def _band_inputs(gauss: dict, cam: Camera, pipe_cfg: PipelineConfig, n: int, rank: int):
    """K3's inputs for rank `rank`'s band of the view over `n` ranks: (fields
    at (geo, invd, ones) = (T, T, T), binning, the band's rows, its first
    row).  The view is preprocessed with the full camera, the means shifted
    by the band's first row, and its ``rows = ceil(H / (32 N)) * 32`` rows
    binned at ``pipe_cfg.tile_capacity``.  A band sorts its tiles with the
    whole image's packed key (its depth resolution), so that near-equal
    depths blend in the single-device render's order: the JAX function keys
    by the band's tile count, and the reordered near-ties move the early
    stop of dense pixels.  No host number is read from the device, and none
    is copied to it, so a band can be captured."""
    H, W = cam.height, cam.width
    rows = -(-H // (TILE_H * n)) * TILE_H
    xyz, quat, opacity = gauss["xyz"], gauss["quat"], gauss["opacity"]
    pre = preprocess(xyz, gauss["scale"], quat, opacity, cam, alive=gauss.get("alive"))
    allmap = main_axis_allmap(xyz, quat, cam)
    r0 = rank * rows
    shift = pre.mean2d.new_zeros(2)
    shift[1:].fill_(r0)  # a fill kernel: a capture refuses the host copy of ``shift[1] = r0``
    local = pre._replace(mean2d=pre.mean2d - shift)
    nty, ntx = tile_grid(H, W)
    binning = bin_gaussians(local, rows, W, capacity=pipe_cfg.tile_capacity,
                            key_tiles=nty * ntx)
    fields = stack_fields(local, torch.ones_like(opacity), allmap, geo=True, invd=True,
                          ones=True)
    return fields, binning, rows, r0


def _band_image(gauss: dict, cam: Camera, pipe_cfg: PipelineConfig, bg, n: int,
                rank: int) -> torch.Tensor:
    """Rank `rank`'s band of the view (``_band_inputs`` blended by K3) in a
    zeroed image of N bands [N rows, W]."""
    fields, binning, rows, r0 = _band_inputs(gauss, cam, pipe_cfg, n, rank)
    W = cam.width
    dt, dev = fields.dtype, fields.device
    bg_t = (bg.to(device=dev, dtype=dt).reshape(1) if torch.is_tensor(bg)
            else torch.full((1,), float(bg), dtype=dt, device=dev))
    band = tile_blend_fwd(fields, binning.gather_idx, binning.counts, bg_t, rows, W, True,
                          True, True)[0]
    img = band.new_zeros((n * rows, W))
    img[r0:r0 + rows] = band
    return img


def tile_parallel_renders(gauss: dict, cam_stacks, geom, pipe_cfg: PipelineConfig, bg,
                          mesh_shape: Tuple[Tuple[str, int], ...], views,
                          graphs: Optional[T.RenderGraphs] = None):
    """``tile_parallel_render_gaussians`` of the stack rows `views` of
    `cam_stacks` (``camera_stacks``: w2c, proj, centre, intrinsics) with
    geometry `geom` (H, W, tanfovx, tanfovy), the counterpart of the JAX
    ``render_tp`` jit; yields each view's [H, W] image in order, the same on
    every rank.  Each rank's band runs through ``render_views``: on CUDA
    tensors one captured graph of `graphs` per key, the SUM across the
    ranks inside it, replayed once per view; on CPU tensors eagerly."""
    n, rank = _mesh_ranks(mesh_shape)
    bg = float(bg)

    def band(g, cam):
        return {"band": _sum_bands(_band_image(g, cam, pipe_cfg, bg, n, rank), n, geom[0])}

    baked = ("tile_parallel", n, rank, pipe_cfg.tile_capacity, bg)
    for _, out in T.render_views(band, gauss, cam_stacks, geom, views, baked, graphs,
                                 collectives=n > 1):
        yield out["band"].clone()
