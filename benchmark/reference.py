"""The plain reference of one training step, in plain PyTorch, which the
benchmark's ``correct`` holds the program's timed chunk against.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's own inputs (``scene.py``: cameras, edge maps, the
initial population) and the configuration file's hyperparameters, and
works out again what the program derives from them: the Gaussians of each
curve, their projection, the tile lists, the blend, the loss with SSIM, the
gradient (by autograd, not the program's hand-derived moment backward) and
the per-group Adam update.  The formulas follow the upstream method as the
program states it (``curve_gaussian_tpu_torch``'s module docstrings), frozen
here:

- curve -> Gaussians: M samples at t = (j + 0.5) / M of the cubic (a line
  as its exact cubic), long axis |B(t) - B(t - 0.5/M)|, short axes the
  width, the minimal rotation of e_x onto the tangent; the Bernstein bases
  rounded to float32;
- projection: near cull z > 0.2, EWA covariance with the 1.3 tanfov clamp
  and a 0.3 px dilation, the conic, radius ceil(3 sqrt(lambda_max)), the
  alpha >= 1/255 support extent;
- tile lists: each Gaussian's clipped rect of 32x32 tiles (4 tiles in the
  first tier, up to 16 for at most ``big_capacity`` Gaussians), the exact
  box cull, one sort by the packed [tile | depth bits] key with the index
  below it, each tile's ``tile_capacity`` nearest kept;
- blend: per tile front to back, power = -0.5(a dx^2 + c dy^2) - b dx dy,
  alpha = min(0.99, opa e^power) (its gradient as if unclamped), a pair
  counts where power <= 0 and alpha >= 1/255, the first with T(1 - alpha)
  < 1e-4 ends the pixel; colour 1 - T (1 - bg), clipped to [0, 1] with
  half the gradient at a bound;
- loss: lambda_mse ((1 - lambda_dssim) edge-aware MSE + lambda_dssim (1 -
  SSIM)) + the opacity log penalty over visible Gaussians + curve
  smoothness + the width penalty (+ the mask sparsity term and the hard
  mask once the mask is on, + the endpoint connectivity term once it is
  on); SSIM with the 11-tap sigma-1.5 window
  (float32 taps) and zero 'same' padding;
- Adam: B1 0.9, B2 0.999, eps 1e-15, bias corrections rounded to float32,
  the position rate log-lerped over ``position_lr_max_steps``.

``precision`` sets what a float32 matrix product may round to: "float32"
(TF32 off: the configuration's precision) or "tf32" (the control).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
TILE = 32
NEAR_CULL_Z = 0.2
H_VAR = 0.3
FRUSTUM_CLAMP = 1.3
MAX_RECT = 16
TIER1_RECT = 4
B1, B2, EPS = 0.9, 0.999, 1e-15
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
# the groups a training step updates: the colour is forced to ones and the
# exposure is not applied, so their gradients are zero by construction
LIVE = ("curve_points", "opacity_raw", "width_raw", "mask_raw")


@contextlib.contextmanager
def precision(mode: str):
    """Float32 matrix products in full float32 ("float32") or TF32
    ("tf32") inside the block."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r} is not 'float32' or 'tf32'")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- curves

def _bases(m: int, dtype, device):
    t = (np.arange(m, dtype=np.float64) + 0.5) / m

    def pos(tv):
        u = 1.0 - tv
        return np.stack([u ** 3, 3 * u ** 2 * tv, 3 * u * tv ** 2, tv ** 3], axis=-1)

    def tan(tv):
        u = 1.0 - tv
        return np.stack([-3 * u ** 2, 3 * u ** 2 - 6 * u * tv, 6 * u * tv - 3 * tv ** 2,
                         3 * tv ** 2], axis=-1)

    return tuple(torch.as_tensor(b.astype(np.float32), device=device).to(dtype)
                 for b in (pos(t), pos(t - 0.5 / m), tan(t)))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis, 0 (with a finite gradient) below 1e-12."""
    sq = (x * x).sum(-1)
    pos = sq > 1e-12
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def gaussians(p: Dict[str, torch.Tensor], is_bezier, alive, m: int, use_mask: bool = False,
              mask_threshold: float = 0.01) -> dict:
    """Per-Gaussian xyz, scale, quat, opacity, alive, tangent of the curves;
    with `use_mask` the straight-through hard mask (sigmoid(mask_raw) >
    `mask_threshold`) gates scale and opacity."""
    cp = p["curve_points"]
    N = cp.shape[0]
    Bp, Bb, Bt = _bases(m, cp.dtype, cp.device)
    p0, p3 = cp[:, 0], cp[:, 3]
    d = (p3 - p0) / 3.0
    cp = torch.where(is_bezier[:, None, None], cp,
                     torch.stack([p0, p0 + d, p0 + 2.0 * d, p3], dim=1))
    xyz = torch.einsum("mk,nkc->nmc", Bp, cp)
    back = torch.einsum("mk,nkc->nmc", Bb, cp)
    tan = torch.einsum("mk,nkc->nmc", Bt, cp)
    s0 = _norm(xyz - back)
    tn = _norm(tan)
    tnz = torch.where(tn > 0, tn, torch.ones_like(tn))
    vx, vy, vz = tan[..., 0] / tnz, tan[..., 1] / tnz, tan[..., 2] / tnz
    w = 1.0 + vx
    qn2 = w * w + vz * vz + vy * vy
    ok = qn2 > 1e-8
    one, zero = torch.ones_like(qn2), torch.zeros_like(qn2)
    qn = torch.where(ok, torch.sqrt(torch.where(ok, qn2, one)), one)
    quat = torch.stack([torch.where(ok, w / qn, zero), zero, torch.where(ok, -vz / qn, one),
                        torch.where(ok, vy / qn, zero)], dim=-1)
    width = torch.exp(p["width_raw"])[:, None].expand(N, m)
    scale = torch.stack([s0, width, width], dim=-1)
    opa = torch.sigmoid(p["opacity_raw"])[:, None].expand(N, m)
    if use_mask:
        sm = torch.sigmoid(p["mask_raw"])
        st = sm + ((sm > mask_threshold).to(sm.dtype) - sm).detach()
        scale = scale * st[..., None]
        opa = opa * st
    return dict(xyz=xyz.reshape(-1, 3), scale=scale.reshape(-1, 3), quat=quat.reshape(-1, 4),
                opacity=opa.reshape(-1), alive=alive[:, None].expand(N, m).reshape(-1),
                tangent=tan.reshape(-1, 3))


# ------------------------------------------------------------ projection

class Pre(NamedTuple):
    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    opacity: torch.Tensor
    radius: torch.Tensor
    extent: torch.Tensor
    valid: torch.Tensor


def _clip(x, lo, hi):
    """min(max(x, lo), hi), half the gradient passing at a tie."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device) if not torch.is_tensor(lo) else lo
    hi = torch.full((), hi, dtype=x.dtype, device=x.device) if not torch.is_tensor(hi) else hi
    return torch.minimum(torch.maximum(x, lo), hi)


def project(g: dict, w2c, proj, H: int, W: int, tanfovx: float, tanfovy: float) -> Pre:
    """Means in pixels, the EWA conic, depth, support and validity."""
    xyz, scale, quat, opacity = g["xyz"], g["scale"], g["quat"], g["opacity"]
    hom = xyz @ proj[:3, :3].T + proj[:3, 3]
    wcl = xyz @ proj[3, :3] + proj[3, 3]
    inv_w = 1.0 / (wcl + 1e-7)
    ndc = hom[:, :2] * inv_w[:, None]
    z = xyz @ w2c[2, :3] + w2c[2, 3]
    # EWA: J W, the frustum clamp inside J
    Wv = w2c[:3, :3]
    tv = xyz @ Wv.T + w2c[:3, 3]
    tz = tv[:, 2]
    fx, fy = W / (2.0 * tanfovx), H / (2.0 * tanfovy)
    limx, limy = FRUSTUM_CLAMP * tanfovx, FRUSTUM_CLAMP * tanfovy
    tx = _clip(tv[:, 0] / tz, -limx, limx) * tz
    ty = _clip(tv[:, 1] / tz, -limy, limy) * tz
    iz = 1.0 / tz
    iz2 = iz * iz
    j00, j02, j11, j12 = fx * iz, -fx * tx * iz2, fy * iz, -fy * ty * iz2
    t0 = [j00 * Wv[0, i] + j02 * Wv[2, i] for i in range(3)]
    t1 = [j11 * Wv[1, i] + j12 * Wv[2, i] for i in range(3)]
    w, x, y, zq = quat.unbind(-1)
    R = [[1.0 - 2.0 * (y * y + zq * zq), 2.0 * (x * y - w * zq), 2.0 * (x * zq + w * y)],
         [2.0 * (x * y + w * zq), 1.0 - 2.0 * (x * x + zq * zq), 2.0 * (y * zq - w * x)],
         [2.0 * (x * zq - w * y), 2.0 * (y * zq + w * x), 1.0 - 2.0 * (x * x + y * y)]]
    u = [(t0[0] * R[0][k] + t0[1] * R[1][k] + t0[2] * R[2][k]) * scale[:, k] for k in range(3)]
    v = [(t1[0] * R[0][k] + t1[1] * R[1][k] + t1[2] * R[2][k]) * scale[:, k] for k in range(3)]
    cxx = u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + H_VAR
    cxy = u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    cyy = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + H_VAR
    det = cxx * cyy - cxy * cxy
    dinv = 1.0 / det
    conic = torch.stack([cyy * dinv, -cxy * dinv, cxx * dinv], dim=-1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * W - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5], dim=-1)
    reach = torch.sqrt(2.0 * torch.clamp(torch.log(torch.clamp(opacity, min=1e-12) * 255.0),
                                         min=0.0))
    ext = reach[:, None] * torch.sqrt(torch.clamp(torch.stack([cxx, cyy], -1), min=0.0))
    valid = (z > NEAR_CULL_Z) & (det > 0.0) & (radius_f > 0.0) & g["alive"]
    radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return Pre(mean2d, conic, z, opacity, radius, ext, valid)


# --------------------------------------------------------------- binning

def tile_grid(H: int, W: int):
    return -(-H // TILE), -(-W // TILE)


def _floor_i32(x, lo, hi):
    return torch.clamp(torch.floor(x), lo - 1, hi + 1).to(torch.int32)


def _rects(pre: Pre, nty: int, ntx: int):
    mx, my = pre.mean2d[:, 0], pre.mean2d[:, 1]
    ex, ey = pre.extent[:, 0], pre.extent[:, 1]
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    x0 = torch.clamp(_floor_i32((mx - ex) / TILE, 0, ntx), 0, ntx)
    x1 = torch.clamp(_floor_i32((mx + ex) / TILE, 0, ntx) + 1, 0, ntx)
    y0 = torch.clamp(_floor_i32((my - ey) / TILE, 0, nty), 0, nty)
    y1 = torch.clamp(_floor_i32((my + ey) / TILE, 0, nty) + 1, 0, nty)
    rw = torch.clamp(x1 - x0, min=0)
    rh = torch.clamp(y1 - y0, min=0)
    rw_c = torch.clamp(rw, max=MAX_RECT)
    rh_c = torch.minimum(rh, torch.clamp(fdiv(torch.full_like(rw_c, MAX_RECT),
                                              torch.clamp(rw_c, min=1)), min=1))
    mean_ty = torch.clamp(_floor_i32(my / TILE, 0, nty), y0, torch.maximum(y1 - 1, y0))
    y0c = torch.clamp(mean_ty - fdiv(rh_c - 1, 2), y0, torch.maximum(y1 - rh_c, y0))
    log_ratio = torch.log(torch.clamp(pre.opacity, min=1e-12) / ALPHA_EPS)
    return dict(x0=x0, rw=rw_c, rh=rh_c, y0=y0c, area=rw * rh, log_ratio=log_ratio)


def _pairs(pre: Pre, rect: dict, T: int, ntx: int, nslots: int, ids):
    """(tile, depth, id) of each of the first `nslots` rect slots of every
    Gaussian, [nslots, P]; a slot that is no candidate gets tile T."""
    mx, my = pre.mean2d[:, 0], pre.mean2d[:, 1]
    ca, cb, cc = pre.conic.unbind(-1)
    r = torch.arange(nslots, dtype=torch.int32, device=mx.device)[:, None]
    rw = torch.clamp(rect["rw"], min=1)
    py = rect["y0"] + torch.div(r, rw, rounding_mode="floor")
    px = rect["x0"] + torch.remainder(r, rw)
    in_rect = (r < rect["rw"] * rect["rh"]) & (py < rect["y0"] + rect["rh"]) & pre.valid
    xl = (px * TILE).to(mx.dtype) - mx
    xh = xl + (TILE - 1)
    yl = (py * TILE).to(mx.dtype) - my
    yh = yl + (TILE - 1)
    q = lambda dx, dy: 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy  # noqa: E731
    ex = lambda x: q(x, torch.minimum(torch.maximum(-cb * x / cc, yl), yh))  # noqa: E731
    ey = lambda y: q(torch.minimum(torch.maximum(-cb * y / ca, xl), xh), y)  # noqa: E731
    qmin = torch.minimum(torch.minimum(ex(xl), ex(xh)), torch.minimum(ey(yl), ey(yh)))
    inside = (xl <= 0.0) & (0.0 <= xh) & (yl <= 0.0) & (0.0 <= yh)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    ok = in_rect & (qmin <= rect["log_ratio"] + 1e-4)
    tiles = torch.where(ok, py * ntx + px, torch.full_like(py, T))
    depth = torch.where(ok, pre.depth, torch.full_like(qmin, torch.inf))
    return tiles, depth, ids.expand(nslots, -1)


@torch.no_grad()
def bin_tiles(pre: Pre, H: int, W: int, capacity: int, big_capacity: int):
    """(gather index [T, K] with sentinel P, counts [T], overflow,
    peak, big count, big overflow)."""
    pre = Pre(*(t.detach() for t in pre))
    nty, ntx = tile_grid(H, W)
    T, K, P = nty * ntx, capacity, pre.mean2d.shape[0]
    dev, i32 = pre.mean2d.device, torch.int32
    rect = _rects(pre, nty, ntx)
    ids = torch.arange(P, dtype=i32, device=dev)
    t1, d1, v1 = _pairs(pre, rect, T, ntx, TIER1_RECT, ids)
    area_c = rect["rw"] * rect["rh"]
    big = pre.valid & (area_c > TIER1_RECT)
    big_count = big.sum().to(i32)
    pos = torch.cumsum(big.to(i32), 0) - 1
    order_big = torch.sort((~big).to(i32), stable=True).indices.to(i32)
    if big_capacity > P:
        order_big = torch.cat([order_big, torch.full((big_capacity - P,), P, dtype=i32,
                                                     device=dev)])
    slot = torch.arange(big_capacity, dtype=i32, device=dev)
    big_idx = torch.where(slot < big_count, order_big[:big_capacity], torch.full_like(slot, P))
    take = lambda a: torch.cat([a, torch.zeros_like(a[:1])])[big_idx.long()]  # noqa: E731
    pre_b = Pre(*(take(a) for a in pre[:6]), take(pre.valid) & (big_idx < P))
    rect_b = {k: take(v) for k, v in rect.items()}
    t2, d2, v2 = (a[TIER1_RECT:] for a in _pairs(pre_b, rect_b, T, ntx, MAX_RECT, big_idx))
    tiles = torch.cat([t1.reshape(-1), t2.reshape(-1)])
    depth = torch.cat([d1.reshape(-1), d2.reshape(-1)])
    vals = torch.cat([v1.reshape(-1), v2.reshape(-1)])
    tbits = (T + 1).bit_length()
    dq = (depth.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF) >> tbits
    key = (tiles.to(torch.int64) << (32 - tbits)) | dq
    order = torch.sort((key << 31) | vals.to(torch.int64)).indices
    st = (key[order] >> (32 - tbits)).to(i32)
    sv = vals[order]
    starts = torch.searchsorted(st, torch.arange(T + 1, dtype=i32, device=dev)).to(i32)
    raw = starts[1:] - starts[:-1]
    counts = torch.clamp(raw, max=K)
    kk = torch.arange(K, dtype=i32, device=dev)
    listed = kk[None, :] < counts[:, None]
    win = torch.cat([sv, torch.full((K,), P, dtype=i32, device=dev)])[
        (starts[:T, None] + kk[None, :]).long()]
    gidx = torch.where(listed, win, torch.full_like(win, P))
    zero = torch.zeros_like(area_c)
    rect_over = torch.where(pre.valid, rect["area"] - area_c, zero).sum()
    big_over = torch.where(big & (pos >= big_capacity), area_c - TIER1_RECT, zero).sum()
    overflow = torch.clamp(raw - K, min=0).sum() + rect_over + big_over
    return gidx, counts, int(overflow), int(raw.max()), int(big_count), int(big_over)


# ----------------------------------------------------------------- blend

def pixels(nty: int, ntx: int, dtype, device):
    """Pixel coordinates [T, 1024] of every tile, row-major in the tile."""
    t = torch.arange(nty * ntx, device=device)
    p = torch.arange(TILE * TILE, device=device)
    px = (t % ntx)[:, None] * TILE + (p % TILE)[None, :]
    py = (t // ntx)[:, None] * TILE + (p // TILE)[None, :]
    return px.to(dtype), py.to(dtype)


def field_rows(pre: Pre) -> torch.Tensor:
    """[P + 1, 6] (mx, my, a, b, c, opacity) of each Gaussian and a zero
    row for the sentinel P (alpha 0: never a candidate)."""
    f = torch.cat([pre.mean2d, pre.conic, pre.opacity[:, None]], dim=-1)
    return torch.cat([f, f.new_zeros((1, 6))])


def blend(fields: torch.Tensor, gidx: torch.Tensor, counts: torch.Tensor, bg: float, H: int,
          W: int) -> torch.Tensor:
    """The edge image [H, W], differentiable in the fields by autograd."""
    nty, ntx = tile_grid(H, W)
    px, py = pixels(nty, ntx, fields.dtype, fields.device)
    pay = fields[gidx.long()]  # [T, K, 6]
    T = torch.ones_like(px)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    for j in range(int(counts.max()) if counts.numel() else 0):
        mx, my, ca, cb, cc, opa = (pay[:, j, i:i + 1] for i in range(6))
        dx, dy = mx - px, my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        a_u = opa * torch.exp(power)
        # the value clamped at 0.99, the gradient as if unclamped
        alpha = torch.clamp_max(a_u.detach(), ALPHA_MAX) + (a_u - a_u.detach())
        cand = ((power <= 0.0) & (alpha >= ALPHA_EPS)).detach()
        ag = torch.where(cand, alpha, torch.zeros_like(alpha))
        rem = T - ag * T
        live = rem >= T_EPS
        contrib = act & cand & live
        act = act & (live | ~cand)
        T = torch.where(contrib, rem, T)
    col = 1.0 - T * (1.0 - bg)
    img = col.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3).reshape(nty * TILE, ntx * TILE)
    return img[:H, :W]


# ------------------------------------------------------------------ loss

def _window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device).to(dtype)


def _band(n: int, w: torch.Tensor) -> torch.Tensor:
    """[n, n] 'same' zero-padded blur operator of the taps `w`."""
    half = w.shape[0] // 2
    i = torch.arange(n, device=w.device)
    d = i[None, :] - i[:, None] + half
    ok = (d >= 0) & (d < w.shape[0])
    return torch.where(ok, w[d.clamp(0, w.shape[0] - 1)], torch.zeros((), dtype=w.dtype,
                                                                        device=w.device))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W] images (separable blur by band matrices)."""
    w = _window(a.dtype, a.device)
    By, Bx = _band(a.shape[0], w), _band(a.shape[1], w)
    m = By @ torch.stack([a, b, a * a, b * b, a * b]) @ Bx
    mu1, mu2, e11, e22, e12 = m
    s = ((2 * mu1 * mu2 + SSIM_C1) * (2 * (e12 - mu1 * mu2) + SSIM_C2)) / (
        (mu1 * mu1 + mu2 * mu2 + SSIM_C1) * (e11 - mu1 * mu1 + e22 - mu2 * mu2 + SSIM_C2))
    return s.mean()


def _masked_mean(x, mask):
    w = mask.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def loss(p: dict, g: dict, pre: Pre, img: torch.Tensor, gt: torch.Tensor, alive,
         opt: dict, m: int, use_mask: bool = False, conn_on: bool = False) -> torch.Tensor:
    pos = gt > 0.1
    npos, nneg = pos.sum().to(img.dtype), (~pos).sum().to(img.dtype)
    n = npos + nneg
    weight = torch.where(pos, 5.0 * (nneg + 1.0) / n, (npos + 1.0) / n)
    l2 = ((img - gt) ** 2 * weight).mean()
    total = opt["lambda_mse"] * ((1.0 - opt["lambda_dssim"]) * l2
                                 + opt["lambda_dssim"] * (1.0 - ssim(img, gt)))
    if use_mask and opt["lambda_mask"] > 0:
        total = total + opt["lambda_mask"] * _masked_mean(
            torch.sigmoid(p["mask_raw"]), alive[:, None].expand(p["mask_raw"].shape))
    visible = (pre.radius > 0) & g["alive"]
    total = total + opt["opacity_loss_weight"] * _masked_mean(
        torch.log1p(g["opacity"] ** 2 / 0.5), visible)
    if opt["lambda_curve_smo"] > 0:
        t = g["tangent"].reshape(-1, m, 3)
        t = t / torch.where(_norm(t) > 0, _norm(t), torch.ones_like(_norm(t)))[..., None]
        per_pair = 1.0 - torch.abs((t[:, :-1] * t[:, 1:]).sum(-1))
        total = total + opt["lambda_curve_smo"] * _masked_mean(
            per_pair, alive[:, None].expand(per_pair.shape))
    if opt["lambda_width"] > 0:
        width = torch.exp(p["width_raw"])
        total = total + opt["lambda_width"] * _masked_mean(
            width - opt["width_floor"], (width >= opt["width_floor"]) & alive)
    if opt["lambda_points_conn"] > 0 and conn_on:
        cp = p["curve_points"]
        ends = torch.cat([cp[:, 0], cp[:, 3]])
        C = cp.shape[0]
        same = torch.eye(C, dtype=torch.bool, device=cp.device).repeat(2, 2)
        d = torch.sqrt(((ends[:, None] - ends[None, :]) ** 2).sum(-1) + 1e-12)
        both = torch.cat([alive, alive])
        near = ((d < opt["conn_dist_threshold"]) & both[:, None] & both[None, :] & ~same).detach()
        total = total + opt["lambda_points_conn"] * _masked_mean(d, near)
    return total


# ------------------------------------------------------------------ Adam

def group_lrs(opt: dict, step: int) -> dict:
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    pos = math.exp(math.log(opt["lr_curve_points_init"]) * (1.0 - t)
                   + math.log(opt["lr_curve_points_final"]) * t)
    return dict(curve_points=pos, opacity_raw=opt["opacity_lr"], width_raw=opt["scaling_lr"],
                mask_raw=opt["mask_lr"])


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict):
    """One Adam step of the live groups; returns (params, mu, nu)."""
    c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    new_p, new_mu, new_nu = dict(params), dict(mu), dict(nu)
    for k, g in grads.items():
        m1 = B1 * mu[k] + (1 - B1) * g
        v1 = B2 * nu[k] + (1 - B2) * g * g
        c1t = torch.full((), c1, dtype=g.dtype, device=g.device)
        c2t = torch.full((), c2, dtype=g.dtype, device=g.device)
        new_p[k] = params[k] - lrs[k] * ((m1 / c1t) / (torch.sqrt(v1 / c2t) + EPS))
        new_mu[k], new_nu[k] = m1, v1
    return new_p, new_mu, new_nu


# ------------------------------------------------------------------ step

class State(NamedTuple):
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int  # the schedule's iteration
    count: int  # Adam's updates so far


def init_state(population, step: int, dtype=torch.float32) -> State:
    """The reference's state of an initial population (``scene.Population``)
    at schedule iteration `step`, Adam's moments at zero."""
    params = {k: getattr(population, k).to(dtype).clone() for k in LIVE}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return State(params, zeros, {k: v.clone() for k, v in zeros.items()}, step, 0)


def view_loss_grads(params: dict, population, cams, view: int, gt: torch.Tensor, opt: dict,
                    pipe: dict, m: int, use_mask: bool = False, conn_on: bool = False):
    """(loss, {group: gradient}, binning overflow) of one view."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        g = gaussians(live, population.is_bezier, population.alive, m, use_mask,
                      opt["mask_threshold"])
        pre = project(g, cams.w2c[view].to(gt.dtype), cams.proj[view].to(gt.dtype),
                      cams.height, cams.width, cams.tanfovx, cams.tanfovy)
        gidx, counts, overflow, *_ = bin_tiles(pre, cams.height, cams.width,
                                               pipe["tile_capacity"], pipe["big_capacity"])
        img = _clip(blend(field_rows(pre), gidx, counts, pipe["bg"], cams.height, cams.width),
                    0.0, 1.0)
        total = loss(live, g, pre, img, gt, population.alive, opt, m, use_mask, conn_on)
        gs = torch.autograd.grad(total, [live[k] for k in LIVE], allow_unused=True)
    grads = {k: (gk if gk is not None else torch.zeros_like(live[k])) for k, gk in zip(LIVE, gs)}
    return total.detach(), grads, overflow


def step(state: State, population, cams, gts: torch.Tensor, views, opt: dict, pipe: dict,
         m: int, use_mask: bool = False, conn_on: bool = False):
    """One optimizer step over the mean gradient of `views` (one view or
    B); returns (new state, mean loss, the step's gradient)."""
    acc, total = None, 0.0
    for v in views:
        lv, gv, _ = view_loss_grads(state.params, population, cams, v, gts[v], opt, pipe, m,
                                    use_mask, conn_on)
        total = total + lv
        acc = gv if acc is None else {k: acc[k] + gv[k] for k in LIVE}
    grads = {k: g / len(views) for k, g in acc.items()}
    with torch.no_grad():
        params, mu, nu = adam(state.params, grads, state.mu, state.nu, state.count + 1,
                              group_lrs(opt, state.step))
    return State(params, mu, nu, state.step + 1, state.count + 1), total / len(views), grads
