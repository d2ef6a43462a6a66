"""Tile binning: per-tile depth-ordered Gaussian lists ([T, K] tables).

The ``sort`` method of ``curve_gaussian_tpu/ops/binning.py``:

  1. every valid Gaussian emits its clipped tile rect as (tile, depth)
     candidate pairs: tier-1 slots [0, tier1_rect) for all, and a big tier
     of ``big_capacity`` Gaussians (compacted in index order) for the few
     whose rect exceeds tier1_rect tiles;
  2. candidacy is the rect overlap AND the exact alpha-support cull: the
     minimum of the power quadratic over the tile's pixel box must reach
     ln(255 opa);
  3. one sort by (tile, depth, index), or by the packed key
     [tile | high depth bits] with the index as tie-break (SORT_PACKED);
  4. tile ranges by ``torch.searchsorted``; the [T, K] table keeps each
     tile's K nearest instances, with sentinel P in empty slots.

The ``pairs`` method (``_bin_pairs``) is the JAX package's independent
round-1 construction, kept as the oracle of the ``sort`` method.

All capacity limits are reported (``overflow``, ``peak``, ``big_count``,
``big_overflow``), never silent.  The JAX package's 1024-column ``idx_pad``
copy exists for a TPU memory rule and is not kept: any K works here.
Binning is integer work and carries no gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import Preprocessed
from .rasterize_ref import ALPHA_EPS, TILE_H, TILE_W

# Sort by the packed [tile | depth bits] key (the default, as in the JAX
# package) or by the exact (tile, depth, index) order.  Parity tests that
# compare against a full-precision depth order pin it False.
SORT_PACKED = True


def tile_grid(height: int, width: int):
    return -(-height // TILE_H), -(-width // TILE_W)


class Binning(NamedTuple):
    gather_idx: torch.Tensor  # [T, K] int32 Gaussian index, depth order per tile
    slot_valid: torch.Tensor  # [T, K] bool
    counts: torch.Tensor  # [T] int32 (clamped to K)
    overflow: torch.Tensor  # [] int32 candidates dropped by K / max_rect / big tier
    peak: torch.Tensor  # [] int32 max per-tile candidate count before the K clamp
    big_count: torch.Tensor  # [] int32 Gaussians past the tier-1 rect
    big_overflow: torch.Tensor  # [] int32 slots dropped because the big tier was full


class _Rect(NamedTuple):
    x0t: torch.Tensor
    y0t: torch.Tensor
    y1t: torch.Tensor
    rw_c: torch.Tensor  # clipped rect width (tiles)
    rh_c: torch.Tensor  # clipped rect height (tiles)
    y0c: torch.Tensor  # clipped rect top row (centred on the mean row)
    area: torch.Tensor  # unclipped rect area (tiles)
    log_ratio: torch.Tensor  # ln(opa * 255)


def _floor_i32(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    # clamp in float first so the int conversion never sees out-of-range
    # values (XLA's conversion saturates; a C cast does not)
    return torch.clamp(torch.floor(x), lo - 1, hi + 1).to(torch.int32)


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _rect_fields(pre: Preprocessed, nty: int, ntx: int, max_rect: int) -> _Rect:
    mx, my = pre.mean2d[:, 0], pre.mean2d[:, 1]
    ex, ey = pre.extent[:, 0], pre.extent[:, 1]
    log_ratio = torch.log(torch.clamp(pre.opacity, min=1e-12) / ALPHA_EPS)
    x0t = torch.clamp(_floor_i32((mx - ex) / TILE_W, 0, ntx), 0, ntx)
    x1t = torch.clamp(_floor_i32((mx + ex) / TILE_W, 0, ntx) + 1, 0, ntx)
    y0t = torch.clamp(_floor_i32((my - ey) / TILE_H, 0, nty), 0, nty)
    y1t = torch.clamp(_floor_i32((my + ey) / TILE_H, 0, nty) + 1, 0, nty)
    rw = torch.clamp(x1t - x0t, min=0)
    rh = torch.clamp(y1t - y0t, min=0)
    rw_c = torch.clamp(rw, max=max_rect)
    rh_c = torch.minimum(
        rh, torch.clamp(_fdiv(torch.full_like(rw_c, max_rect), torch.clamp(rw_c, min=1)), min=1)
    )
    # a clipped rect keeps the rows nearest the mean
    mean_ty = torch.clamp(
        _floor_i32(my / TILE_H, 0, nty), y0t, torch.maximum(y1t - 1, y0t)
    )
    y0c = torch.clamp(mean_ty - _fdiv(rh_c - 1, 2), y0t, torch.maximum(y1t - rh_c, y0t))
    return _Rect(x0t, y0t, y1t, rw_c, rh_c, y0c, rw * rh, log_ratio)


def _emit_pairs(pre: Preprocessed, rect: _Rect, T: int, ntx: int, max_rect: int, ids):
    """(tile id, sort depth, value) [R, P] per rect slot; non-candidates get
    tile T and depth inf."""
    mx, my = pre.mean2d[:, 0], pre.mean2d[:, 1]
    fdt = mx.dtype
    ca, cb, cc = pre.conic[:, 0], pre.conic[:, 1], pre.conic[:, 2]
    r = torch.arange(max_rect, dtype=torch.int32, device=mx.device)[:, None]
    rw_s = torch.clamp(rect.rw_c, min=1)
    py_t = rect.y0c + _fdiv(r, rw_s)
    px_t = rect.x0t + torch.remainder(r, rw_s)
    in_rect = (r < rect.rw_c * rect.rh_c) & (py_t < rect.y0c + rect.rh_c) & pre.valid
    # exact alpha cull: the box minimum of q(d) = 0.5(a dx^2 + c dy^2) + b dx dy
    # is at the origin (if inside) or on an edge, where the 1-D minimiser
    # is -b*edge/other clamped to the box
    tx0 = (px_t * TILE_W).to(fdt)
    ty0 = (py_t * TILE_H).to(fdt)
    xl, xh = tx0 - mx, tx0 + (TILE_W - 1) - mx
    yl, yh = ty0 - my, ty0 + (TILE_H - 1) - my

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(x):
        return q(x, torch.minimum(torch.maximum(-cb * x / cc, yl), yh))

    def edge_y(y):
        return q(torch.minimum(torch.maximum(-cb * y / ca, xl), xh), y)

    qmin = torch.minimum(
        torch.minimum(edge_x(xl), edge_x(xh)), torch.minimum(edge_y(yl), edge_y(yh))
    )
    inside = (xl <= 0.0) & (0.0 <= xh) & (yl <= 0.0) & (0.0 <= yh)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    ok = in_rect & (qmin <= rect.log_ratio + 1e-4)
    tiles = torch.where(ok, py_t * ntx + px_t, torch.full_like(py_t, T))
    d = torch.where(ok, pre.depth, torch.full_like(qmin, torch.inf))
    return tiles, d, ids.expand(max_rect, -1)


def _depth_bits(d: torch.Tensor) -> torch.Tensor:
    """Bit pattern of float32 depths as non-negative int64 (monotone in the
    depth for positive values)."""
    return d.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@torch.no_grad()
def bin_gaussians(
    pre: Preprocessed,
    height: int,
    width: int,
    capacity: int = 1024,
    max_rect: int = 16,
    method: str = "sort",
    tier1_rect: int = 4,
    big_capacity: int = 1024,
    packed: bool | None = None,
) -> Binning:
    if method not in ("sort", "pairs"):
        raise ValueError(f"binning method {method!r} is not 'sort' or 'pairs'")
    if packed is None:
        packed = SORT_PACKED
    pre = Preprocessed(*(t.detach() for t in pre))
    nty, ntx = tile_grid(height, width)
    if method == "pairs":
        return _bin_pairs(pre, nty, ntx, capacity, max_rect)
    T = nty * ntx
    K = capacity
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    i32 = torch.int32
    rect = _rect_fields(pre, nty, ntx, max_rect)
    ids = torch.arange(P, dtype=i32, device=dev)
    tiles1, d1, v1 = _emit_pairs(pre, rect, T, ntx, tier1_rect, ids)

    # big tier: Gaussians whose clipped rect exceeds tier1_rect, compacted
    # in index order (stable sort on "not big") into big_capacity slots
    area_c = rect.rw_c * rect.rh_c
    big = pre.valid & (area_c > tier1_rect)
    big_count = big.sum().to(i32)
    pos = torch.cumsum(big.to(i32), 0) - 1
    bsorted = torch.sort((~big).to(i32), stable=True).indices.to(i32)
    if big_capacity > P:
        bsorted = torch.cat([bsorted, torch.full((big_capacity - P,), P, dtype=i32, device=dev)])
    slot = torch.arange(big_capacity, dtype=i32, device=dev)
    big_idx = torch.where(slot < big_count, bsorted[:big_capacity], torch.full_like(slot, P))
    bl = big_idx.long()

    def take(a):
        return torch.cat([a, torch.zeros_like(a[:1])])[bl]

    pre_big = Preprocessed(
        mean2d=take(pre.mean2d),
        conic=take(pre.conic),
        depth=take(pre.depth),
        opacity=take(pre.opacity),
        radius=take(pre.radius),
        extent=take(pre.extent),
        valid=take(pre.valid) & (big_idx < P),
    )
    rect_big = _Rect(*(take(a) for a in rect))
    tiles2, d2, v2 = _emit_pairs(pre_big, rect_big, T, ntx, max_rect, big_idx)
    tiles2, d2, v2 = tiles2[tier1_rect:], d2[tier1_rect:], v2[tier1_rect:]

    tiles_flat = torch.cat([tiles1.reshape(-1), tiles2.reshape(-1)])
    depth_flat = torch.cat([d1.reshape(-1), d2.reshape(-1)])
    vals = torch.cat([v1.reshape(-1), v2.reshape(-1)])
    if packed:
        # uint32 [tile | depth bits >> tbits] key with the index below it:
        # bit for bit the JAX package's packed (key, index) sort
        tbits = (T + 1).bit_length()
        dq = _depth_bits(depth_flat) >> tbits
        key = (tiles_flat.to(torch.int64) << (32 - tbits)) | dq
        order = torch.sort((key << 31) | vals.to(torch.int64)).indices
        st = (key[order] >> (32 - tbits)).to(i32)
    else:
        # exact (tile, depth, index) order: index order first, then one
        # stable sort on the depth-and-tile key
        order = torch.argsort(vals, stable=True)
        if depth_flat.dtype == torch.float32:
            key = (tiles_flat.to(torch.int64) << 32) | _depth_bits(depth_flat)
            order = order[torch.argsort(key[order], stable=True)]
        else:  # float64 depths do not fit beside the tile in 64 bits
            order = order[torch.argsort(depth_flat[order], stable=True)]
            order = order[torch.argsort(tiles_flat[order], stable=True)]
        st = tiles_flat[order]
    sv = vals[order]

    starts = torch.searchsorted(st, torch.arange(T + 1, dtype=i32, device=dev)).to(i32)
    raw = starts[1:] - starts[:-1]
    counts = torch.clamp(raw, max=K)
    kk = torch.arange(K, dtype=i32, device=dev)
    slot_valid = kk[None, :] < counts[:, None]
    sv_ext = torch.cat([sv, torch.full((K,), P, dtype=i32, device=dev)])
    win = sv_ext[(starts[:T, None] + kk[None, :]).long()]
    gather_idx = torch.where(slot_valid, win, torch.full_like(win, P))

    zero = torch.zeros_like(area_c)
    rect_overflow = torch.where(pre.valid, rect.area - area_c, zero).sum()
    big_overflow = torch.where(big & (pos >= big_capacity), area_c - tier1_rect, zero).sum()
    overflow = torch.clamp(raw - K, min=0).sum() + rect_overflow + big_overflow
    return Binning(
        gather_idx=gather_idx.contiguous(),
        slot_valid=slot_valid,
        counts=counts.contiguous(),
        overflow=overflow.to(i32),
        peak=raw.max().to(i32),
        big_count=big_count,
        big_overflow=big_overflow.to(i32),
    )


def _bin_pairs(pre: Preprocessed, nty: int, ntx: int, K: int, max_rect: int) -> Binning:
    """The ``pairs`` method: a depth argsort, every Gaussian's max_rect rect
    slots as candidate pairs, a dense [T, P] prefix count that ranks each
    pair within its tile, and a scatter into the [T, K] table.  O(T P)
    memory: an independent construction for tests, not for the hot path.
    It has no big tier, so big_count and big_overflow are zero."""
    T = nty * ntx
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    i32 = torch.int32
    order = torch.argsort(torch.where(pre.valid, pre.depth, torch.full_like(pre.depth, torch.inf)),
                          stable=True)
    pre_s = Preprocessed(*(a[order] for a in pre))
    rect = _rect_fields(pre_s, nty, ntx, max_rect)
    tiles, _, _ = _emit_pairs(pre_s, rect, T, ntx, max_rect, torch.arange(P, dtype=i32, device=dev))
    tiles = tiles.T.long()  # [P, R]; T for non-candidates
    ok = tiles < T
    zero = torch.zeros_like(rect.area)
    rect_overflow = torch.where(pre_s.valid, rect.area - rect.rw_c * rect.rh_c, zero).sum()

    # depth rank of each candidate within its tile, from dense prefix counts
    p_cols = torch.arange(P, device=dev)[:, None].expand(P, max_rect)
    count_grid = torch.zeros((T + 1, P), dtype=i32, device=dev)
    count_grid.index_put_((tiles, p_cols), ok.to(i32), accumulate=True)
    prefix = torch.cumsum(count_grid[:T], dim=1, dtype=i32)  # [T, P]
    total = prefix[:, -1]
    flat = torch.cat([prefix.reshape(-1), torch.zeros(P, dtype=i32, device=dev)])  # row T: zeros
    slot = flat[tiles * P + p_cols] - 1

    target = torch.where(ok & (slot < K) & (slot >= 0), tiles * K + slot,
                         torch.full_like(tiles, T * K))
    gather_flat = torch.full((T * K + 1,), P, dtype=i32, device=dev)  # last slot: the drop
    gather_flat[target.reshape(-1)] = order.to(i32)[:, None].expand(P, max_rect).reshape(-1)
    gather_idx = gather_flat[: T * K].reshape(T, K)

    counts = torch.clamp(total, max=K)
    slot_valid = torch.arange(K, dtype=i32, device=dev)[None, :] < counts[:, None]
    overflow = torch.clamp(total - K, min=0).sum() + rect_overflow
    z = torch.zeros((), dtype=i32, device=dev)
    return Binning(
        gather_idx=gather_idx.contiguous(),
        slot_valid=slot_valid,
        counts=counts.to(i32).contiguous(),
        overflow=overflow.to(i32),
        peak=total.max().to(i32),
        big_count=z,
        big_overflow=z,
    )
