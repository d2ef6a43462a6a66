"""Compositing constants, tile geometry and tile membership.

The semantics, from ``curve_gaussian_tpu/ops/rasterize_ref.py``: for each
pixel, Gaussians on its tile's list are taken in increasing view depth; a
Gaussian contributes iff power = -0.5(a dx^2 + c dy^2) - b dx dy <= 0 and
alpha = min(0.99, opa exp(power)) >= 1/255, and the first Gaussian with
T (1 - alpha) < 1e-4 ends the pixel without contributing.

The full-channel ``rasterize_reference`` oracle belongs to a later slice.
"""
from __future__ import annotations

import torch

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99
TILE_H = 32
TILE_W = 32


def membership(binning, num_gaussians: int) -> torch.Tensor:
    """[P, T] bool: Gaussian p is on tile t's (possibly truncated) list."""
    T, K = binning.gather_idx.shape
    mem = torch.zeros((num_gaussians + 1, T), dtype=torch.bool, device=binning.gather_idx.device)
    rows = torch.where(
        binning.slot_valid,
        binning.gather_idx.long(),
        torch.full_like(binning.gather_idx, num_gaussians, dtype=torch.long),
    )
    cols = torch.arange(T, device=rows.device)[:, None].expand(T, K)
    mem[rows, cols] = True
    return mem[:num_gaussians]
