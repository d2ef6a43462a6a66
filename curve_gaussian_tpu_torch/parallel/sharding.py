"""The view-batched training step, as ``curve_gaussian_tpu/parallel/
sharding.py`` at one device.

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

Only one device runs here: ``mesh_shape`` (``mesh`` for
``camera_batch_arrays``) is None or ``(("data", 1),)``, where the JAX
function's collectives are identities that it skips.  More devices (the
gradient all-reduce, ``make_mesh``) and the tile-parallel render belong to
later slices of the port and raise.

On CUDA tensors ``parallel_train_steps_scan`` captures the whole B-view
step, every view's forward and backward included, as one CUDA graph per
shape key and replays it through the chunk (``engine/train.py::
StepGraphs``); on CPU tensors the same body runs eagerly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..engine import train as T
from ..engine.train import StepGraphs, TrainState
from ..ops.camera import Camera, index_camera, stack_cameras


def _one_device(mesh_shape) -> None:
    """Raise unless `mesh_shape` asks for one device."""
    if mesh_shape is not None and tuple(map(tuple, mesh_shape)) != (("data", 1),):
        raise NotImplementedError(
            f"mesh_shape {mesh_shape!r}: more than one device is the multi-device slice "
            "of the port (ROADMAP slice 11b); this module runs on one device, "
            "mesh_shape None or (('data', 1),)")


def batch_cameras(cams: Sequence[Camera]) -> Camera:
    return stack_cameras(list(cams))


def camera_batch_arrays(cams: Sequence[Camera], mesh=None):
    """Stack per-view camera arrays (w2c [B,4,4], proj [B,4,4], centres
    [B,3]); `mesh` as ``mesh_shape`` (one device, no placement)."""
    _one_device(mesh)
    return tuple(torch.stack([getattr(c, f) for c in cams])
                 for f in ("world_to_cam", "full_proj", "cam_center"))


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
    defaults to the state's.  The JAX function's collectives are identities
    at one device and have no counterpart here."""
    if use_exposure and view_idx is None:
        raise ValueError("use_exposure requires per-view train indices")
    nb = gts.shape[0]
    if n_gaussians is None:
        n_gaussians = ts.params["mask_raw"].shape[1]
    acc = None
    for v in range(nb):
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
    gp, goff, tot, vis, rad, ov, peak, big_ov = acc
    gp = {k: g / nb for k, g in gp.items()}
    new_ts = T.update_state(ts, gp, goff / nb, vis, rad, opt_cfg, (cams.height, cams.width),
                            lr_row)
    metrics = {
        "total": tot / nb,
        "overflow": ov,
        "n_visible": vis.sum(),
        "tile_peak": peak,
        "big_overflow": big_ov,
    }
    return new_ts, metrics


def _batch_camera(cam_arrays, cam_geom) -> Camera:
    h, w, tfx, tfy = cam_geom
    return Camera(world_to_cam=cam_arrays[0], full_proj=cam_arrays[1],
                  cam_center=cam_arrays[2], height=h, width=w, tanfovx=tfx, tanfovy=tfy,
                  intrinsics=cam_arrays[3] if len(cam_arrays) == 4 else None)


def parallel_train_step(
    ts: TrainState,
    cam_arrays,  # (w2c [B,4,4], proj [B,4,4], centers [B,3][, intrinsics [B,4]])
    gts: torch.Tensor,  # [B, H, W]
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]],
    cam_geom: Tuple[int, int, float, float],
    conn_on: bool | None = None,
    view_indices=None,  # [B] ints (use_exposure)
    use_exposure: bool = False,
):
    """One step over a B-view batch, eagerly; returns (new TrainState,
    metrics).  The input state is not modified."""
    _one_device(mesh_shape)
    if use_exposure and view_indices is None:
        raise ValueError("use_exposure requires per-view train indices")
    return _local_batch_step(ts, _batch_camera(cam_arrays, cam_geom), gts, bg, opt_cfg,
                             pipe_cfg, use_mask, conn_on=conn_on, view_idx=view_indices,
                             use_exposure=use_exposure)


def parallel_train_steps_scan(
    ts: TrainState,
    cam_arrays,  # (w2c [K,B,4,4], proj [K,B,4,4], centers [K,B,3]), or [V,...] with rows
    gts: torch.Tensor,  # [K, B, H, W], or [V, H, W] with rows
    bg,
    opt_cfg: OptimizationConfig,
    pipe_cfg: PipelineConfig,
    use_mask: bool,
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]],
    cam_geom: Tuple[int, int, float, float],
    conn_on: bool | None = None,
    n_active=None,
    view_indices=None,  # [K, B] ints (use_exposure)
    use_exposure: bool = False,
    *,
    rows=None,
    graphs: Optional[StepGraphs] = None,
):
    """K steps of B views each as one chunk; returns (state, {metric: [K]
    float64}).

    Without ``rows``, step i takes the B views ``cam_arrays[:, ...][i]``
    and ``gts[i]``, the JAX function's per-step arrays.  With ``rows``, a
    [K, B] table, `cam_arrays` (intrinsics [V,4] optional) and `gts` are
    stacks of all V views and step i takes the rows ``rows[i]``, as the
    driver gives them.  ``view_indices`` [K, B] are the views' exposure
    rows.  Steps at or past ``n_active`` leave the state as it is.  On CUDA
    tensors the B-view step is captured once per shape key into a graph of
    ``graphs`` (a ``StepGraphs`` of ``_local_batch_step``, new for this call
    when None) and replayed K times; a capture that fails raises.  On CPU
    tensors the same body runs eagerly, bitwise equal to K calls of
    ``parallel_train_step``."""
    _one_device(mesh_shape)
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
                       use_exposure,
                       graphs if graphs is not None else StepGraphs(_local_batch_step),
                       batched=True)
