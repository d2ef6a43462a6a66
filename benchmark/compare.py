"""The comparison that decides ``correct``: the program's first three
training steps, taken through the window's own chunk call in set-up, held
against the plain reference (``reference.py``) run over the same
population, views and edge maps once the window has closed.

Three numbers, each against the cell's limit (``limits/<cell>.json``):

- ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the three steps;
- ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from the program's Adam state after one step (mu / (1 - B1)), by the
  worst leaf: | |g_prog| - |g_ref| | over the larger of |g_ref| of that
  leaf and of the median leaf;
- ``change_gap``: the parameters' change over the three steps, by the
  worst leaf alike, over the leaves whose reference gradient reaches a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

from . import reference as R

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    """max over `leaves` of |prog - ref| / max(ref, the median leaf's ref)."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else
            float(prog[k] != ref[k]) for k in leaves]
    return max(gaps)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers from each side's losses [3], first gradient and
    change over three steps ({leaf: tensor})."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    gp, gr = _norms(prog["grad"]), _norms(ref["grad"])
    leaves = list(R.LIVE)
    grad = worst_leaf(gp, gr, leaves)
    med = statistics.median(gr[k] for k in leaves)
    moved = [k for k in leaves if gr[k] >= 1e-3 * med]
    change = worst_leaf(_norms(prog["change"]), _norms(ref["change"]), moved)
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change)


def program_side(first: dict) -> dict:
    """The program's side from what set-up kept of its first steps: the
    losses, the Adam state after step 1 and the parameters after step 3."""
    return dict(losses=first["losses"],
                grad={k: first["mu1"][k] / (1.0 - R.B1) for k in R.LIVE},
                change={k: first["p3"][k] - first["p0"][k] for k in R.LIVE})


def reference_side(config: dict, traffic: dict, scene, population, rows, mode: str = "float32",
                   dtype=torch.float32) -> dict:
    """The reference's losses, first gradient and change over the steps
    `rows` (three lists of views) from `population`, in `mode`
    (``reference.precision``)."""
    phase = traffic["phase"]
    pipe = dict(traffic["pipeline"], bg=1.0 if config["model"]["white_background"] else 0.0)
    m = config["model"]["n_gaussians"]
    opt = dict(config["optimization"])
    if phase["opacity_frozen"]:
        opt["opacity_lr"] = 0.0
    gts = scene.gts.to(dtype)
    with R.precision(mode):
        st = R.init_state(population, phase["step"], dtype)
        p0 = {k: v.clone() for k, v in st.params.items()}
        losses, grad = [], None
        for views in rows:
            st, total, g = R.step(st, population, scene.cams, gts, views, opt, pipe, m,
                                  phase["use_mask"], phase["conn_on"])
            losses.append(float(total))
            grad = g if grad is None else grad
    return dict(losses=losses, grad=grad, change={k: st.params[k] - p0[k] for k in R.LIVE})
