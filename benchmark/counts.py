"""The yardstick of the kernels' roofline shares: the published peaks of one
NVIDIA H100 SXM and the bytes and float operations each training kernel
needs, counted from its inputs, frozen here from the program's own counts
(``PERF.md`` section 6).

A kernel's least time is max(bytes / 3.35 TB/s, float32 operations / 67
TFLOP/s, exp2 / 4.19 T/s); its roofline share is that over its device
time.  Every input byte is counted read once and every output byte written
once.  The blend kernels' work depends on the data, so it is charged to
the (instance, pixel) pairs of the inputs that need it: the gate (offsets,
power, expf, alpha, two tests) and one exp2 to every candidate pair (a
live pair inside the instance's alpha >= 1/255 support; a pair outside
needs no evaluation), the rest to each contributing pair (a candidate that
passes the transmittance test).  The peaks assume the card's full 700 W.
"""
from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, an FMA counts 2
PEAK_EX2_PER_S = PEAK_F32_FLOP_PER_S / 16  # the special-function unit: 16 a clock and SM

EXPF_OPS = 10  # expf on sm_90a: 4 FFMA (2 each), FADD, FMUL, and one MUFU.EX2
GATE_OPS = 2 + 9 + EXPF_OPS + 2 + 2  # offsets, power, expf, alpha (mul, min), two tests
T_OPS = 3  # alpha T, T - alpha T, the T test
MOMENT_OPS = T_OPS + 2 + 2 + 4 + 12  # prefix, 1/(1-a), g_alpha, 6 products and 6 sums
K7_OPS = 239  # a pixel of SSIM: products 3, two 11-tap passes over 5 maps 220, the map 16
K8_OPS = 437  # a pixel of its gradient: moments 223, d-maps 30, adjoint blur 176, combine 8
REDUCE_OPS = 8  # a listed slot row added to its Gaussian's row
SLOT_ROWS = 16  # rows of the binning's slots table: 4 first-tier and 12 big-tier rect slots
NF = 8  # floats of a Gaussian's field row
TILE = 32


def least_seconds(nbytes: float, nops: float, nexp: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOP_PER_S, nexp / PEAK_EX2_PER_S)


def padded_rows(P: int) -> int:
    """Field rows of P Gaussians: P + 1 (the sentinel) rounded up to 8."""
    return -(-(P + 1) // 8) * 8


@torch.no_grad()
def pair_counts(fields: torch.Tensor, gidx: torch.Tensor, counts: torch.Tensor, H: int,
                W: int) -> dict:
    """The (instance, pixel) pairs of one blend's inputs, by the plain
    front-to-back pass: live (in the image, not yet stopped, listed),
    candidate (live and through power <= 0, alpha >= 1/255), contributing
    (candidates through the T test), and the instances with a contributing
    pair.  `fields` [P + 1, >= 6] holds (mx, my, a, b, c, opacity) with a
    zero sentinel row; `gidx` [T, K] and `counts` [T] are the tile lists."""
    nty, ntx = -(-H // TILE), -(-W // TILE)
    dev = fields.device
    t = torch.arange(nty * ntx, device=dev)
    p = torch.arange(TILE * TILE, device=dev)
    px = ((t % ntx)[:, None] * TILE + (p % TILE)[None, :]).to(fields.dtype)
    py = ((t // ntx)[:, None] * TILE + (p // TILE)[None, :]).to(fields.dtype)
    act = (px < W) & (py < H)
    T = torch.ones_like(px)
    pay = fields[gidx.long()]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n = dict(live=zero, cand=zero, contrib=zero, inst=zero)
    for j in range(int(counts.max()) if counts.numel() else 0):
        listed = (j < counts)[:, None]
        mx, my, ca, cb, cc, opa = (pay[:, j, i:i + 1] for i in range(6))
        dx, dy = mx - px, my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(opa * torch.exp(power), 0.99)
        cand = (power <= 0.0) & (alpha >= 1.0 / 255.0) & listed
        rem = T - torch.where(cand, alpha, torch.zeros_like(alpha)) * T
        live_t = rem >= 1e-4
        was = act & listed
        contrib = act & cand & live_t
        n["live"] = n["live"] + was.sum()
        n["cand"] = n["cand"] + (was & cand).sum()
        n["contrib"] = n["contrib"] + contrib.sum()
        n["inst"] = n["inst"] + contrib.any(dim=1).sum()
        act = act & (live_t | ~cand)
        T = torch.where(contrib, rem, T)
    return {k: int(v) for k, v in n.items()}


def blend_train_seconds(P: int, n_inst: int, tiles: int, H: int, W: int, pairs: dict) -> dict:
    """Least seconds of K1 (forward), K2 (its moment backward: the
    function's bytes, the slots table left to the reduction) and the slot
    -> Gaussian reduction on one view's inputs."""
    P1 = padded_rows(P)
    k1 = least_seconds(P1 * NF * 4 + n_inst * 4 + tiles * 4 + 4 + 2 * H * W * 4,
                       pairs["cand"] * GATE_OPS + pairs["contrib"] * T_OPS, pairs["cand"])
    k2 = least_seconds(P1 * NF * 4 + n_inst * 4 + tiles * 4 + 4 * H * W * 4 + P1 * NF * 4,
                       pairs["cand"] * GATE_OPS + pairs["contrib"] * MOMENT_OPS, pairs["cand"])
    red = least_seconds(n_inst * NF * 4 + SLOT_ROWS * P * 4 + P1 * NF * 4, n_inst * REDUCE_OPS)
    return dict(blend_train_fwd=k1, blend_train_bwd=k2, reduce_slots=red)


def ssim_seconds(H: int, W: int) -> dict:
    """Least seconds of K7 (two images in, the value out) and K8 (two
    images and the value in, two gradient images out) at H x W."""
    return dict(ssim_fwd=least_seconds(2 * H * W * 4, H * W * K7_OPS),
                ssim_bwd=least_seconds(4 * H * W * 4, H * W * K8_OPS))
