"""Per-group Adam with exponential-log learning-rate schedules, as
``curve_gaussian_tpu/engine/optim.py``.

An explicit Adam (not ``torch.optim``) whose ``mu``/``nu`` dictionaries
mirror the parameter dictionary row for row, so that topology surgery can
slice them with the parameters.  Groups: curve_points (log-lerp over
position_lr_max_steps), features_dc, opacity_raw, width_raw, mask_raw
(constant) and exposure (log-lerp over the run).  eps = 1e-15.  A group
absent from the gradients (its gradient is zero by construction) passes
through untouched, the same as a zero-gradient update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from ..config import OptimizationConfig

B1, B2, EPS = 0.9, 0.999, 1e-15
# the parameter groups, in the column order of a chunk's learning-rate table
GROUPS = ("curve_points", "features_dc", "opacity_raw", "width_raw", "mask_raw", "exposure")


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> float:
    """Log-linear interpolation from lr_init to lr_final over max_steps."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        s = min(max(step / lr_delay_steps, 0.0), 1.0)
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(0.5 * math.pi * s)
    else:
        delay = 1.0
    return delay * log_lerp


def group_lrs(opt: OptimizationConfig, step: int) -> Dict[str, float]:
    return {
        "curve_points": expon_lr(
            step, opt.lr_curve_points_init, opt.lr_curve_points_final, opt.position_lr_max_steps
        ),
        "features_dc": opt.feature_lr,
        "opacity_raw": opt.opacity_lr,
        "width_raw": opt.scaling_lr,
        "mask_raw": opt.mask_lr,
        "exposure": expon_lr(
            step, opt.exposure_lr_init, opt.exposure_lr_final, opt.iterations,
            opt.exposure_lr_delay_steps, opt.exposure_lr_delay_mult,
        ),
    }


def bias_corrections(count: int):
    """Adam's bias corrections (1 - B1^count, 1 - B2^count) of update
    `count`, rounded to float32 as the JAX package computes them."""
    c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    return c1, c2


def lr_row(opt: OptimizationConfig, step: int, count: int) -> List[float]:
    """One row of a chunk's learning-rate table: the group rates at `step`
    in ``GROUPS`` order, then the bias corrections of update `count`."""
    lrs = group_lrs(opt, step)
    return [lrs[g] for g in GROUPS] + list(bias_corrections(count))


@torch.no_grad()
def adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lrs: Dict[str, float],
    bias=None,
):
    """One Adam step; returns (new params, new AdamState).  Groups absent
    from ``grads`` pass through.  The inputs are not modified.  ``lrs`` and
    ``bias`` (the bias corrections, from the count when None) may be 0-dim
    tensors on the parameters' device."""
    count = state.count + 1
    if bias is None:
        # 0-dim tensors filled on the device, as a step graph reads them from
        # its table: on the card a division by a host scalar multiplies by
        # its reciprocal, which rounds otherwise than the division
        p0 = next(iter(params.values()))
        bias = tuple(torch.full((), c, dtype=p0.dtype, device=p0.device)
                     for c in bias_corrections(count))
    c1, c2 = bias
    new_p, new_mu, new_nu = {}, {}, {}
    for k in params:
        if k not in grads:
            new_p[k], new_mu[k], new_nu[k] = params[k], state.mu[k], state.nu[k]
            continue
        g = grads[k]
        mu = B1 * state.mu[k] + (1 - B1) * g
        nu = B2 * state.nu[k] + (1 - B2) * g * g
        update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        new_p[k] = params[k] - lrs[k] * update
        new_mu[k] = mu
        new_nu[k] = nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)
