"""Checkpoint and resume of the whole TrainState, in the npz schema (v2) of
``curve_gaussian_tpu/engine/checkpoint.py``.

Every leaf is stored under the JAX package's pytree path name
(``params/curve_points``, ``opt/mu/width_raw``, ``opt/count``, ``step``,
``opacity_frozen``, ...) in its dtype there (float32 parameters, int32 step
and count, bool flags), beside ``__schema_version``, ``__capacity`` and
``__step``.  A checkpoint written by either package therefore loads into
the other's TrainState of the same capacity, which carries a model across
between the two; the errors raise with the JAX package's messages.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from .optim import AdamState
from .train import TrainState

SCHEMA_VERSION = 2
_META = "__schema_version"
_TOP = ("is_bezier", "alive", "xyz_grad_accum", "denom", "max_radii", "step", "opacity_frozen")


def named_leaves(ts: TrainState) -> Dict[str, object]:
    """{pytree path name: leaf} in the JAX package's flattening order
    (dataclass fields in order, dictionary keys sorted)."""
    out = {}
    for prefix, d in (("params", ts.params), ("opt/mu", ts.opt.mu), ("opt/nu", ts.opt.nu)):
        for k in sorted(d):
            out[f"{prefix}/{k}"] = d[k]
    out["opt/count"] = ts.opt.count
    for k in _TOP:
        out[k] = getattr(ts, k)
    return out


def leaf_array(leaf) -> np.ndarray:
    """A leaf as the JAX package stores it: tensors as they are, the step
    and the Adam count as int32, the frozen flag as bool."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_)
    return np.asarray(leaf, np.int32)


def save_checkpoint(path: str, ts: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        **{k: leaf_array(v) for k, v in named_leaves(ts).items()},
        **{_META: SCHEMA_VERSION, "__capacity": ts.alive.shape[0], "__step": int(ts.step)},
    )


def _check_schema(data, path: str):
    if _META not in data.files:
        raise ValueError(
            f"{path}: not a v{SCHEMA_VERSION} checkpoint (missing "
            f"'{_META}'). Pre-round-2 'leaf_<i>' checkpoints are no longer "
            "readable; re-save from a live TrainState."
        )
    v = int(data[_META])
    if v != SCHEMA_VERSION:
        raise ValueError(f"{path}: checkpoint schema v{v}, this build reads v{SCHEMA_VERSION}")


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore into the structure of `template` (same capacity and shapes),
    on its device and in its dtypes."""
    with np.load(path) as data:
        _check_schema(data, path)
        new = {}
        for name, leaf in named_leaves(template).items():
            if name not in data.files:
                raise ValueError(
                    f"{path}: checkpoint missing leaf '{name}' — saved by an "
                    "older TrainState layout"
                )
            arr = data[name]
            shape = tuple(leaf.shape) if torch.is_tensor(leaf) else ()
            if arr.shape != shape:
                raise ValueError(
                    f"{path}: leaf '{name}' has shape {arr.shape}, template "
                    f"{shape} — capacity mismatch; rebuild the template at "
                    "the saved capacity"
                )
            if torch.is_tensor(leaf):
                new[name] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
            else:
                new[name] = type(leaf)(arr.item())

    def group(prefix, d):
        return {k: new[f"{prefix}/{k}"] for k in d}

    return TrainState(
        params=group("params", template.params),
        opt=AdamState(mu=group("opt/mu", template.opt.mu), nu=group("opt/nu", template.opt.nu),
                      count=new["opt/count"]),
        **{k: new[k] for k in _TOP},
    )


def checkpoint_capacity(path: str) -> Tuple[int, int]:
    """(capacity, step) read from the checkpoint's metadata."""
    with np.load(path) as data:
        _check_schema(data, path)
        return int(data["__capacity"]), int(data["__step"])
