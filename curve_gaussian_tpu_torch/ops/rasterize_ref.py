"""Reference rasterizer, compositing constants, tile geometry and tile
membership, as ``curve_gaussian_tpu/ops/rasterize_ref.py``.

The semantics: for each pixel, Gaussians that are valid and candidates of
its tile are taken in increasing view depth; a Gaussian contributes iff
power = -0.5(a dx^2 + c dy^2) - b dx dy <= 0 and
alpha = min(0.99, opa exp(power)) >= 1/255, and the first Gaussian with
T (1 - alpha) < 1e-4 ends the pixel without contributing.  Each
contribution adds ch alpha T to every channel (colour, inverse depth, the
four allmap channels) and multiplies T by 1 - alpha; the colour adds
T_final bg at the end.

``rasterize_reference`` is that definition written out in plain PyTorch,
differentiable by autograd: slow (one step per Gaussian over every pixel),
and the oracle of the tile kernels.  Candidacy is tile-granular: pass
``membership`` of the binning to reproduce the kernels' candidates,
per-tile capacity truncation included; without it every valid Gaussian is
a candidate everywhere.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99
TILE_H = 32
TILE_W = 32


def depth_order(pre) -> torch.Tensor:
    """Indices of all Gaussians sorted by view depth (stable), invalid ones
    last."""
    key = torch.where(pre.valid, pre.depth, torch.full_like(pre.depth, torch.inf))
    return torch.argsort(key, stable=True)


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


def _blend_chunk(T, active, C, invD, AM, rows, valid, mem, pixx, pixy, tile_idx):
    """Composite a chunk of depth-ordered Gaussian rows [n, 12] over every
    pixel; returns the new (T, active, C, invD, AM)."""
    for i in range(rows.shape[0]):
        g = rows[i]
        mx, my, ca, cb, cc, opa, col, inv_depth = (g[k] for k in range(8))
        dx = mx - pixx
        dy = my - pixy
        inside = mem[i][tile_idx] & valid[i]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        # straight-through min: the forward clamps at 0.99, the gradient
        # flows as if unclamped (d alpha / d opa = G, as the original CUDA)
        alpha_u = opa * torch.exp(power)
        alpha = alpha_u + (torch.clamp_max(alpha_u, ALPHA_MAX) - alpha_u).detach()
        cand = inside & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_T = torch.where(cand, T * (1.0 - alpha), T)
        newly_done = cand & (test_T < T_EPS)
        contrib = cand & ~newly_done & active
        w = torch.where(contrib, alpha * T, torch.zeros_like(T))
        C = C + col * w
        invD = invD + inv_depth * w
        AM = AM + g[8:12, None] * w[None, :]
        T = torch.where(contrib, test_T, T)
        active = active & ~newly_done
    return T, active, C, invD, AM


def rasterize_reference(pre, color: torch.Tensor, allmap: torch.Tensor, bg, height: int,
                        width: int, chunk: int = 32, render_geo: bool = True,
                        member: torch.Tensor | None = None):
    """Returns dict(render [H,W], invdepth [H,W], allmap [4,H,W], final_T [H,W]).

    color [P] (ones for the edge image), allmap [P, 4], bg a scalar; member
    [P, T] the tile candidacy (see the module docstring).  The Gaussians
    are composited in chunks of ``chunk``, each under activation
    checkpointing, so autograd keeps one chunk's intermediates at a time."""
    order = depth_order(pre).detach()
    P = pre.mean2d.shape[0]
    dt, dev = pre.mean2d.dtype, pre.mean2d.device
    npix = height * width
    pixx = torch.arange(width, dtype=dt, device=dev).repeat(height)
    pixy = torch.arange(height, dtype=dt, device=dev).repeat_interleave(width)
    one = torch.ones_like(pre.depth)
    inv_depth = torch.where(pre.valid, 1.0 / torch.where(pre.valid, pre.depth, one),
                            torch.zeros_like(one))
    rows = torch.cat(
        [pre.mean2d, pre.conic, pre.opacity[:, None], color[:, None], inv_depth[:, None], allmap],
        dim=-1,
    )[order]
    valid = pre.valid[order]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    pix = torch.arange(npix, device=dev)
    if member is None:
        mem = torch.ones((P, 1), dtype=torch.bool, device=dev)
        tile_idx = torch.zeros_like(pix)
    else:
        mem = member[order]
        ntx = member.shape[1] // max(-(-height // TILE_H), 1)
        tile_idx = (pix // width // TILE_H) * ntx + (pix % width) // TILE_W
    state = (
        torch.ones(npix, dtype=dt, device=dev),
        torch.ones(npix, dtype=torch.bool, device=dev),
        torch.zeros(npix, dtype=dt, device=dev),
        torch.zeros(npix, dtype=dt, device=dev),
        torch.zeros((4, npix), dtype=dt, device=dev),
    )
    for c0 in range(0, P, chunk):
        args = (*state, rows[c0 : c0 + chunk], valid[c0 : c0 + chunk], mem[c0 : c0 + chunk],
                pixx, pixy, tile_idx)
        if torch.is_grad_enabled():
            state = checkpoint(_blend_chunk, *args, use_reentrant=False)
        else:
            state = _blend_chunk(*args)
    T, _, C, invD, AM = state
    return {
        "render": (C + T * bg).reshape(height, width),
        "invdepth": invD.reshape(height, width),
        "final_T": T.reshape(height, width),
        "allmap": AM.reshape(4, height, width) if render_geo
        else torch.zeros((4, height, width), dtype=dt, device=dev),
    }
