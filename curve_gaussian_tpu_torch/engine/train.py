"""Training step, TrainState and the eval render, as
``curve_gaussian_tpu/engine/train.py``.

One step = gaussians -> render (training configuration) -> total_loss ->
backward -> per-group Adam -> densification statistics.  PyTorch runs
eagerly, so there is no compiled step; ``train_steps`` is a plain loop in
place of the JAX package's ``lax.scan`` chunk.  With ``use_exposure`` the
view's learned exposure (scale, offset) applies to the render and its group
is trained.  ``eval_render`` renders every channel of the current state.
The training loop, with topology surgery and the capacity policy, is
``engine/loop.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..models import curve_state as cs
from ..models import losses as L
from ..ops.camera import Camera
from ..ops.render import render
from . import optim


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
    ``use_exposure`` the row ``view_idx`` of the exposure applies to the
    render, and the exposure group is live."""
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
        out = render(
            gauss["xyz"], gauss["scale"], gauss["quat"], gauss["opacity"], cam,
            bg=bg, alive=gauss["alive"], mean2d_offset=offset,
            antialiasing=pipe_cfg.antialiasing,
            # the loss reads only the colour channel
            render_geo=False, compute_invdepth=False,
            capacity=pipe_cfg.tile_capacity, big_capacity=pipe_cfg.big_capacity,
            backend=pipe_cfg.backend,
            exposure=params["exposure"][view_idx] if use_exposure else None,
        )
        loss, aux = L.total_loss(state, out, gauss, gt_image, opt_cfg, use_mask, conn_on=conn_on)
        names = list(live)
        gs = torch.autograd.grad(loss, [live[k] for k in names] + [offset], allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(live[k])) for k, g in zip(names, gs)}
    goffset = gs[-1] if gs[-1] is not None else torch.zeros_like(offset)
    visible = out["visibility"] & gauss["alive"]
    telemetry = {k: out[k] for k in ("overflow", "tile_peak", "big_peak", "big_overflow")}
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, grads, goffset, visible, out["radii"], telemetry


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
):
    """One training step; returns (new TrainState, metrics).  The input
    state is not modified."""
    _, aux, grads, goffset, visible, radii, telemetry = step_grads(
        ts, cam, gt_image, bg, opt_cfg, pipe_cfg, use_mask, n_gaussians, conn_on=conn_on,
        view_idx=view_idx, use_exposure=use_exposure,
    )
    lrs = optim.group_lrs(opt_cfg, ts.step)
    if ts.opacity_frozen:
        lrs["opacity_raw"] = 0.0
    new_params, new_opt = optim.adam_update(ts.params, grads, ts.opt, lrs)

    with torch.no_grad():
        # accumulated norm of the screen-space gradient of visible Gaussians,
        # in the reference's NDC * 0.5 * size units
        ndc = torch.stack(
            [goffset[:, 0] * (0.5 * cam.width), goffset[:, 1] * (0.5 * cam.height)], dim=-1
        )
        gnorm = torch.linalg.vector_norm(ndc, dim=-1)
        vis_f = visible.to(gnorm.dtype)
        new_ts = TrainState(
            params=new_params,
            opt=new_opt,
            is_bezier=ts.is_bezier,
            alive=ts.alive,
            xyz_grad_accum=ts.xyz_grad_accum + gnorm * vis_f,
            denom=ts.denom + vis_f,
            max_radii=torch.maximum(ts.max_radii, torch.where(visible, radii, torch.zeros_like(radii))),
            step=ts.step + 1,
            opacity_frozen=ts.opacity_frozen,
        )
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
    ``n_gaussians`` has no counterpart: it is unused there too."""
    gauss = cs.gaussians(cs.curve_state_of(ts), use_mask=use_mask, mask_threshold=mask_threshold)
    if use_exposure and view_idx is None:
        raise ValueError("use_exposure requires the view's train index")
    return render(
        gauss["xyz"], gauss["scale"], gauss["quat"], gauss["opacity"], cam,
        bg=bg, alive=gauss["alive"], antialiasing=pipe_cfg.antialiasing,
        render_geo=pipe_cfg.render_geo, capacity=pipe_cfg.tile_capacity,
        big_capacity=pipe_cfg.big_capacity, backend=pipe_cfg.backend,
        exposure=ts.params["exposure"][view_idx] if use_exposure else None,
    )

