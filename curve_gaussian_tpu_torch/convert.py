"""Carry a model across from the JAX package's state, as numpy arrays.

``state_from_numpy`` takes the leaves of a ``CurveState`` and
``train_state_from_numpy`` those of a ``TrainState`` (Adam ``mu``/``nu``/
``count`` included), each as plain numpy arrays (for example
``np.asarray`` of the JAX leaves), and return the port's state on `device`.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .engine import optim
from .engine.train import TrainState
from .models.curve_state import TRAINABLE_FIELDS, CurveState


def _t(a, dev, dtype=None):
    t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


def _params(params: Dict[str, np.ndarray], dev, dtype) -> Dict[str, torch.Tensor]:
    missing = set(TRAINABLE_FIELDS) - set(params)
    if missing:
        raise KeyError(f"missing trainable fields: {sorted(missing)}")
    return {k: _t(params[k], dev, dtype) for k in TRAINABLE_FIELDS}


def state_from_numpy(params: Dict[str, np.ndarray], is_bezier, alive, device="cuda",
                     dtype=None) -> CurveState:
    """CurveState from its six trainable arrays and the two topology masks.
    `dtype` defaults to each array's own floating type."""
    dev = resolve_device(device)
    p = _params(params, dev, dtype)
    return CurveState(**p, is_bezier=_t(is_bezier, dev, torch.bool), alive=_t(alive, dev, torch.bool))


def train_state_from_numpy(
    params: Dict[str, np.ndarray],
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
    count: int,
    is_bezier,
    alive,
    xyz_grad_accum,
    denom,
    max_radii,
    step: int,
    opacity_frozen: bool = False,
    device="cuda",
    dtype=None,
) -> TrainState:
    """TrainState from the JAX TrainState's leaves (Adam moments included)."""
    dev = resolve_device(device)
    return TrainState(
        params=_params(params, dev, dtype),
        opt=optim.AdamState(mu=_params(mu, dev, dtype), nu=_params(nu, dev, dtype), count=int(count)),
        is_bezier=_t(is_bezier, dev, torch.bool),
        alive=_t(alive, dev, torch.bool),
        xyz_grad_accum=_t(xyz_grad_accum, dev, dtype),
        denom=_t(denom, dev, dtype),
        max_radii=_t(max_radii, dev, torch.int32),
        step=int(step),
        opacity_frozen=bool(opacity_frozen),
    )
