"""Training-configuration tile blend: kernels K1 (forward) and K2 (backward).

The counterpart of ``curve_gaussian_tpu/ops/rasterize_pallas.py::blend_train``
for ones colour with no inverse-depth or allmap channel, the configuration
every training step renders.

K1 ``blend_train_fwd`` replaces ``_make_fwd_train_paired`` (and its unpaired
odd-width form ``_make_fwd_kernel(False, False, True)``).  Per 32x32 tile it
composites the tile's depth-ordered instances front to back:
power = -0.5 (a dx^2 + c dy^2) - b dx dy, alpha = min(0.99, opa e^power),
an instance counts only where power <= 0 and alpha >= 1/255, and the first
one with T (1 - alpha) < 1e-4 ends the pixel without contributing.  With
ones colour the colour is 1 - T (1 - bg).

K2 ``blend_train_bwd`` replaces ``_make_bwd_moment_rmw_paired`` (and the
unpaired ``_make_bwd_moment_rmw_kernel``); K6b ``blend_train_bwd_basis``
(the ``basis`` flavor) replaces ``_make_bwd_moment_rmw_basis_kernel``.  One front-to-back pass carries
T and the prefix pr += gc w, so that
g_alpha = gc T_i + (base_inv + pr) / (1 - alpha), base_inv = -gtt finT - gc col,
and reduces the six moments of D' = g_alpha G (D', D'dx, D'dy, D'dx^2,
D'dx dy, D'dy^2) over each tile's pixels into a [P1, 8] accumulator;
``moments_to_dfields`` maps them linearly to d(mx, my, ca, cb, cc, opa).
K6b reaches the same six moments from six raw sums of D' in tile-local
pixel coordinates (weights at most 31^2), added per slot into a zeroed
[T, K, 8] scratch, and a second kernel's binomial recombination per
(instance, tile); it exists as the JAX package's A/B formulation of the
backward.
The derivative of alpha ignores the 0.99 clamp (d alpha / d opa = G), as
the JAX kernels and the original CUDA rasterizer do, so the backward is the
hand-derived moment formula and never autograd through the clamp.

What bounds the kernels on an H100: per-pixel serial chains of about twenty
float operations and one ``expf`` per (instance, pixel), so instruction
throughput, not memory (a tile's fields are a few KB), and the longest tile
lists.  See ``csrc/tile_blend.cu`` for what the design does about it: K1,
K2 and K6b split each tile over four blocks, and each warp skips the
instances whose ``support_box`` misses its pixel rectangle, which keeps
every result exact.

Every sum of the backward is taken in a fixed order, so the same inputs
give the same bits on every launch, as the JAX package's backward does on
its in-order TPU grid.  K2 and K6b write each instance slot's moments into
a [T, K, 8] table of slot rows (K2's kernel is K5's), summed over a tile's
pixels in warp, warp-index and quarter order; ``reduce_slots`` (the
slot -> Gaussian reduction kernel) then adds each Gaussian's slot rows in
(tile, slot) order, which the binning lists in ``Binning.slots``.  The
plain versions reduce with ``index_add_``, which adds in that same order on
the CPU.

Every wrapper takes the plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.  The TPU layout of the JAX
kernels (tile pairing, (8,128) register tiles, tiled outputs) is not
copied: the outputs are spatial [H, W] images.

The module also holds the per-Gaussian field rows of every channel set
(``field_layout``, ``stack_fields``), which the full-channel blend of
``tile_blend_cuda`` (kernels K3, K4, K5) reads too.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .binning import tile_grid
from .projection import Preprocessed
from .rasterize_ref import ALPHA_EPS, ALPHA_MAX, T_EPS, TILE_H, TILE_W

NF = 8  # training field row: mx, my, ca, cb, cc, opa, 0, 0
TILE_PIX = TILE_H * TILE_W

_VP = ctypes.c_void_p
_I = ctypes.c_int


def field_layout(geo: bool, invd: bool, ones: bool):
    """({field name: column}, NF) of a channel set: mx, my, ca, cb, cc, opa,
    then [col] (a per-splat colour, absent with ones colour), [invd],
    [am0..am3], padded to NF = 8 or 16 columns."""
    names = ["mx", "my", "ca", "cb", "cc", "opa"]
    if not ones:
        names.append("col")
    if invd:
        names.append("invd")
    if geo:
        names += ["am0", "am1", "am2", "am3"]
    nf = -(-len(names) // 8) * 8
    return {n: i for i, n in enumerate(names)}, nf


def stack_fields(pre: Preprocessed, color=None, allmap=None, geo: bool = False,
                 invd: bool = False, ones: bool = True) -> torch.Tensor:
    """[P1, NF] per-Gaussian field rows in the ``field_layout`` order.

    The defaults are the training channel set, (mx, my, ca, cb, cc, opa, 0,
    0); ``color`` [P] and ``allmap`` [P, 4] are read when the set has them.
    The inverse depth is 0 on culled rows through a double ``where``, so a
    zero cotangent there never meets 1/0.  Rows P..P1-1 are zeros, P1 = P + 1
    rounded up to 8: the binning writes the sentinel index P into empty
    slots, and a zero row blends alpha 0."""
    L, nf = field_layout(geo, invd, ones)
    cols = [pre.mean2d[:, 0], pre.mean2d[:, 1], pre.conic[:, 0], pre.conic[:, 1],
            pre.conic[:, 2], pre.opacity]
    if "col" in L:
        cols.append(color)
    if "invd" in L:
        one = torch.ones_like(pre.depth)
        cols.append(torch.where(pre.valid, 1.0 / torch.where(pre.valid, pre.depth, one),
                                torch.zeros_like(one)))
    if "am0" in L:
        cols += [allmap[:, i] for i in range(4)]
    z = torch.zeros_like(pre.opacity)
    fields = torch.stack(cols + [z] * (nf - len(cols)), dim=-1)
    P = fields.shape[0]
    pad = -(-(P + 1) // 8) * 8 - P
    return torch.cat([fields, fields.new_zeros((pad, nf))], dim=0)


def _pixels(nty: int, ntx: int, dtype, device):
    """Pixel coordinates [T, 1024] of every tile in row-major pixel order."""
    t = torch.arange(nty * ntx, device=device)
    p = torch.arange(TILE_PIX, device=device)
    px = (t % ntx)[:, None] * TILE_W + (p % TILE_W)[None, :]
    py = (t // ntx)[:, None] * TILE_H + (p // TILE_W)[None, :]
    return px.to(dtype), py.to(dtype)


def _to_tiles(img: torch.Tensor, nty: int, ntx: int) -> torch.Tensor:
    """[H, W] -> [T, 1024], zero-padded to whole tiles."""
    H, W = img.shape
    pad = img.new_zeros((nty * TILE_H, ntx * TILE_W))
    pad[:H, :W] = img
    return pad.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3).reshape(-1, TILE_PIX)


def _from_tiles(x: torch.Tensor, nty: int, ntx: int, H: int, W: int) -> torch.Tensor:
    img = x.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3)
    return img.reshape(nty * TILE_H, ntx * TILE_W)[:H, :W].contiguous()


# slack of K1/K2's support box (csrc/tile_blend.cu: BOX_*)
BOX_GROW, BOX_PX, BOX_T_SLACK, BOX_DET_SLACK, BOX_T_EMPTY = 1.001, 1.0, 1e-5, 4e-6, 2e-5


def support_box(fields: torch.Tensor) -> torch.Tensor:
    """[P1, 4] float32 (x0, x1, y0, y1): per field row, the pixel box
    outside which no pixel passes the gate power <= 0, alpha >= 1/255.

    The float32 mirror of K1/K2's ``support_box`` in ``csrc/tile_blend.cu``,
    in its order of operations: the axis-aligned box of the ellipse
    -power <= t = ln(255 op), with det lowered and t and the half-widths
    grown enough to cover float32 rounding; empty when op < 1/255, the
    whole plane when the conic is not positive definite or a value is not
    finite.  A pixel p lies in the box when x0 <= p.x <= x1 and y0 <= p.y
    <= y1."""
    mx, my, ca, cb, cc, op = fields[:, :6].to(torch.float32).unbind(1)
    t = torch.log(255.0 * op)
    cacc = ca * cc
    cb2 = cb * cb
    dlo = (cacc - cb2) - BOX_DET_SLACK * (cacc.abs() + cb2)
    t2 = 2.0 * (torch.clamp(t, min=0.0) + BOX_T_SLACK)
    hx = torch.sqrt(t2 * cc / dlo) * BOX_GROW + BOX_PX
    hy = torch.sqrt(t2 * ca / dlo) * BOX_GROW + BOX_PX
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=1)
    inf = torch.inf
    whole = torch.isnan(t) | ~(dlo > 0.0) | ~torch.isfinite(box).all(dim=1)
    box = torch.where(whole[:, None], box.new_tensor([-inf, inf, -inf, inf]), box)
    return torch.where((t < -BOX_T_EMPTY)[:, None], box.new_tensor([inf, -inf, inf, -inf]), box)


def _composite_step(f, px, py, T, act):
    """One instance slot of the front-to-back pass over all tiles at once.

    f: [T, 8] fields of slot j of every tile.  Returns the instance's
    Gaussian G, gated alpha, offsets, whether it contributed, the new
    transmittance and liveness."""
    mx, my, ca, cb, cc, opa = (f[:, i : i + 1] for i in range(6))
    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp_max(opa * G, ALPHA_MAX)
    cand = (power <= 0.0) & (alpha >= ALPHA_EPS)
    ag = torch.where(cand, alpha, torch.zeros_like(alpha))
    rem = T - ag * T
    live = rem >= T_EPS
    contrib = act & cand & live
    act = act & (live | ~cand)
    return G, ag, dx, dy, contrib, torch.where(contrib, rem, T), act


def blend_train_fwd_plain(fields, gidx, counts, bg, H: int, W: int):
    """Plain PyTorch K1: (col, finT), each [H, W]."""
    nty, ntx = tile_grid(H, W)
    px, py = _pixels(nty, ntx, fields.dtype, fields.device)
    pay = fields[gidx.long()]  # [T, K, 8]
    T = torch.ones_like(px)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    for j in range(int(counts.max()) if counts.numel() else 0):
        _, _, _, _, _, T, act = _composite_step(pay[:, j], px, py, T, act)
    col = 1.0 - T * (1.0 - bg.reshape(()))
    return _from_tiles(col, nty, ntx, H, W), _from_tiles(T, nty, ntx, H, W)


def _adjoints(fields, gidx, counts, col, finT, gc, gtt):
    """K2's front-to-back pass over the instance slots of every tile at
    once: yields (j, D', dx, dy), each [T, 1024], for slot j, where
    D' = g_alpha G of the contributing pairs and 0 elsewhere."""
    H, W = col.shape
    nty, ntx = tile_grid(H, W)
    px, py = _pixels(nty, ntx, fields.dtype, fields.device)
    pay = fields[gidx.long()]
    gc_t = _to_tiles(gc, nty, ntx)
    binv = -_to_tiles(gtt, nty, ntx) * _to_tiles(finT, nty, ntx) - gc_t * _to_tiles(col, nty, ntx)
    T = torch.ones_like(px)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    pr = torch.zeros_like(px)
    zero = torch.zeros_like(px)
    for j in range(int(counts.max()) if counts.numel() else 0):
        Ti = T
        G, ag, dx, dy, contrib, T, act = _composite_step(pay[:, j], px, py, T, act)
        pr = pr + gc_t * torch.where(contrib, ag * Ti, zero)
        gal = gc_t * Ti + (1.0 / (1.0 - ag)) * (binv + pr)
        yield j, torch.where(contrib, gal, zero) * G, dx, dy


def moment_rows_plain(fields, gidx, counts, col, finT, gc, gtt):
    """K2's moments per instance slot, [T, K, 8] (columns 0-5), before any
    reduction to Gaussians: the plain version of K5, and of K2 once
    index-added.  Slots past the longest tile list stay zero."""
    mom = fields.new_zeros(gidx.shape + (NF,))
    for j, Dp, dx, dy in _adjoints(fields, gidx, counts, col, finT, gc, gtt):
        e1 = Dp * dx
        e2 = Dp * dy
        mom[:, j, :6] = torch.stack([Dp, e1, e2, e1 * dx, e1 * dy, e2 * dy], dim=-1).sum(dim=1)
    return mom


def moment_rows_basis_plain(fields, gidx, counts, col, finT, gc, gtt):
    """K6b's moments per instance slot, [T, K, 8]: the same D' as
    ``moment_rows_plain``, reduced to the raw sums S0, Sx, Sy, Sxx, Sxy, Syy
    in tile-local pixel coordinates (x' = x - 32 tx, y' = y - 32 ty), then
    recombined around the instance's local centre (cx, cy) = mean - tile
    origin, in the kernel's order of operations."""
    nty, ntx = tile_grid(*col.shape)
    p = torch.arange(TILE_PIX, device=fields.device)
    lx = (p % TILE_W).to(fields.dtype)[None, :]
    ly = (p // TILE_W).to(fields.dtype)[None, :]
    t = torch.arange(nty * ntx, device=fields.device)
    tx0 = ((t % ntx) * TILE_W).to(fields.dtype)
    ty0 = ((t // ntx) * TILE_H).to(fields.dtype)
    mom = fields.new_zeros(gidx.shape + (NF,))
    for j, Dp, _, _ in _adjoints(fields, gidx, counts, col, finT, gc, gtt):
        e1 = Dp * lx
        e2 = Dp * ly
        S0, Sx, Sy, Sxx, Sxy, Syy = (
            v.sum(dim=1) for v in (Dp, e1, e2, e1 * lx, e1 * ly, e2 * ly))
        mean = fields[gidx[:, j].long()]
        cx = mean[:, 0] - tx0
        cy = mean[:, 1] - ty0
        mom[:, j, :6] = torch.stack([
            S0,
            cx * S0 - Sx,
            cy * S0 - Sy,
            cx * (cx * S0 - 2.0 * Sx) + Sxx,
            cx * cy * S0 - cx * Sy - cy * Sx + Sxy,
            cy * (cy * S0 - 2.0 * Sy) + Syy,
        ], dim=-1)
    return mom


def _reduce_rows(fields, gidx, mom):
    """Slot rows [T, K, NF] -> per-Gaussian rows [P1, NF] with ``index_add_``
    (on the CPU it adds the slots in (tile, slot) order)."""
    nf = mom.shape[-1]
    return fields.new_zeros((fields.shape[0], nf)).index_add_(0, gidx.reshape(-1).long(),
                                                              mom.reshape(-1, nf))


def reduce_slots_plain(rows, slots, P1: int):
    """Plain PyTorch slot -> Gaussian reduction: out[P1, NF] from the slot
    rows [T, K, NF] (or [T * K, NF]) through the binning's ``slots`` [R, P]
    (each Gaussian's slot rows tile * K + j in (tile, slot) order, -1 for
    none), in the kernel's order: Gaussian p adds rows slots[0, p],
    slots[1, p], ... to zero."""
    nf = rows.shape[-1]
    flat = rows.reshape(-1, nf)
    R, P = slots.shape
    out = rows.new_zeros((P1, nf))
    acc = out[:P]
    for r in range(R):
        s = slots[r].long()
        take = (s >= 0)[:, None]
        acc = torch.where(take, acc + flat[s.clamp(min=0)], acc)
    out[:P] = acc
    return out


def blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt):
    """Plain PyTorch K2: the [P1, 8] moment accumulator (columns 0-5)."""
    return _reduce_rows(fields, gidx, moment_rows_plain(fields, gidx, counts, col, finT, gc, gtt))


def blend_train_bwd_basis_plain(fields, gidx, counts, col, finT, gc, gtt):
    """Plain PyTorch K6b: K2's accumulator through the tile-local basis."""
    return _reduce_rows(fields, gidx,
                        moment_rows_basis_plain(fields, gidx, counts, col, finT, gc, gtt))


def moments_to_dfields(M: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian moment rows [P1, 8] -> field gradients [P1, 8]."""
    ca, cb, cc, opa = fields[:, 2], fields[:, 3], fields[:, 4], fields[:, 5]
    M0, M1, M2, M3, M4, M5 = (M[:, i] for i in range(6))
    z = torch.zeros_like(M0)
    return torch.stack(
        [
            -opa * (ca * M1 + cb * M2),
            -opa * (cc * M2 + cb * M1),
            -0.5 * opa * M3,
            -opa * M4,
            -0.5 * opa * M5,
            M0,
            z,
            z,
        ],
        dim=-1,
    )


def _lib():
    """The blend kernels' library, ``csrc/tile_blend.cu``, with the argument
    types of all five entry points (K1, the K2/K5/K6b moments and the
    reduction here; K3, K4 in ``tile_blend_cuda``)."""
    lib = _build.load("tile_blend")
    if not getattr(lib, "_typed", False):
        for name, nptr, nint in (("blend_train_fwd", 6, 5), ("blend_train_bwd", 10, 6),
                                 ("tile_blend_fwd", 8, 8), ("tile_blend_bwd", 14, 8),
                                 ("slot_reduce", 3, 4)):
            fn = getattr(lib, name)
            fn.argtypes = [_VP] * nptr + [_I] * nint + [_VP]
            fn.restype = _I
        lib._typed = True
    return lib


def _check_tables(fields, gidx, counts, H: int, W: int, nf: int = NF):
    dev = fields.device
    if fields.dtype != torch.float32 or fields.dim() != 2 or fields.shape[1] != nf:
        raise ValueError(f"fields must be float32 [P1, {nf}], got {fields.dtype} {tuple(fields.shape)}")
    nty, ntx = tile_grid(H, W)
    if gidx.dtype != torch.int32 or gidx.dim() != 2 or gidx.shape[0] != nty * ntx:
        raise ValueError(f"gather_idx must be int32 [{nty * ntx}, K], got {gidx.dtype} {tuple(gidx.shape)}")
    if counts.dtype != torch.int32 or counts.shape != (nty * ntx,):
        raise ValueError(f"counts must be int32 [{nty * ntx}], got {counts.dtype} {tuple(counts.shape)}")
    for name, t in (("fields", fields), ("gather_idx", gidx), ("counts", counts)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
    return nty, ntx


def _check_bg(bg, dev):
    if bg.dtype != torch.float32 or bg.numel() != 1 or bg.device != dev:
        raise ValueError("bg must be a float32 tensor of one element on the fields' device")
    return bg.contiguous()


def _check_image(name, t, H, W, dev):
    if t.dtype != torch.float32 or t.shape != (H, W) or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [{H}, {W}] tensor on {dev}")


def blend_train_fwd(fields, gidx, counts, bg, H: int, W: int):
    """K1: (col, finT) [H, W].  fields [P1, 8] float32, gidx [T, K] int32
    with sentinel P in empty slots, counts [T] int32, bg [1]."""
    if not fields.is_cuda:
        return blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    nty, ntx = _check_tables(fields, gidx, counts, H, W)
    bg = _check_bg(bg, fields.device)
    col = torch.empty((H, W), dtype=torch.float32, device=fields.device)
    finT = torch.empty_like(col)
    lib = _lib()
    code = lib.blend_train_fwd(
        fields.data_ptr(), gidx.data_ptr(), counts.data_ptr(), bg.data_ptr(),
        col.data_ptr(), finT.data_ptr(), H, W, nty, ntx, gidx.shape[1],
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(lib, code, "blend_train_fwd")
    blend_train_fwd.launches += 1
    return col, finT


def bwd_scratch(gidx, nv: int):
    """The scratch of a backward kernel's fixed-order sums: each quarter
    block's sums [T, 4, nv, K] (every slot a tile lists is written before it
    is read) and the zeroed tickets [T] int32, one per tile."""
    T, K = gidx.shape
    qrows = torch.empty((T, 4, nv, K), dtype=torch.float32, device=gidx.device)
    return qrows, torch.zeros((T,), dtype=torch.int32, device=gidx.device)


def moment_rows(fields, gidx, counts, col, finT, gc, gtt, basis: bool = False):
    """K2's kernel (K5's; K6b's with ``basis``): the moments per slot
    [T, K, 8], every row written (zeros past a tile's count); the plain
    versions for CPU tensors.  Its callers count its launches."""
    if not fields.is_cuda:
        plain = moment_rows_basis_plain if basis else moment_rows_plain
        return plain(fields, gidx, counts, col, finT, gc, gtt)
    H, W = col.shape
    _check_tables(fields, gidx, counts, H, W)
    if fields.data_ptr() % 16:
        raise ValueError("fields must start on a 16-byte boundary (the kernels read float4)")
    for arg, t in (("col", col), ("finT", finT), ("gc", gc), ("gtt", gtt)):
        _check_image(arg, t, H, W, fields.device)
    qrows, tickets = bwd_scratch(gidx, 6)
    rows = torch.empty(gidx.shape + (NF,), dtype=torch.float32, device=fields.device)
    lib = _lib()
    nty, ntx = tile_grid(H, W)
    code = lib.blend_train_bwd(
        *(t.data_ptr() for t in (fields, gidx, counts, col, finT, gc, gtt, qrows, tickets, rows)),
        H, W, nty, ntx, gidx.shape[1], int(basis),
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(lib, code, "blend_train_bwd")
    return rows


def reduce_slots(rows, slots, P1: int):
    """The slot -> Gaussian reduction: per-Gaussian rows [P1, NF] (NF = 8 or
    16) from the slot rows [T, K, NF] of a backward kernel, each Gaussian's
    rows added in (tile, slot) order through ``slots`` [R, P] int32
    (``Binning.slots``); rows P .. P1 - 1 are zeros."""
    if not rows.is_cuda:
        return reduce_slots_plain(rows, slots, P1)
    if slots is None:
        raise ValueError("the slot -> Gaussian reduction on the card needs the binning's "
                         "slots table (Binning.slots)")
    nf = rows.shape[-1]
    if rows.dtype != torch.float32 or nf not in (8, 16) or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous float32 [..., 8 or 16], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    R, P = slots.shape
    if (slots.dtype != torch.int32 or slots.device != rows.device or not slots.is_contiguous()
            or P > P1):
        raise ValueError(f"slots must be a contiguous int32 [R, P <= {P1}] tensor on "
                         f"{rows.device}, got {slots.dtype} {tuple(slots.shape)}")
    out = torch.empty((P1, nf), dtype=torch.float32, device=rows.device)
    lib = _lib()
    code = lib.slot_reduce(rows.data_ptr(), slots.data_ptr(), out.data_ptr(), nf, R, P, P1,
                           torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(lib, code, "slot_reduce")
    reduce_slots.launches += 1
    return out


def blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt, slots):
    """K2: moment accumulator [P1, 8] from the forward's col/finT and the
    cotangents gc (colour) and gtt (final T), all [H, W]: the moments per
    slot, then ``reduce_slots`` through the binning's ``slots`` (the plain
    version on the CPU does not read them)."""
    if not fields.is_cuda:
        return blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    rows = moment_rows(fields, gidx, counts, col, finT, gc, gtt)
    blend_train_bwd.launches += 1
    return reduce_slots(rows, slots, fields.shape[0])


def blend_train_bwd_basis(fields, gidx, counts, col, finT, gc, gtt, slots):
    """K6b: K2's moment accumulator [P1, 8] through six tile-local raw sums
    per instance and their recombination (the ``basis`` flavor of the
    training backward); same arguments as ``blend_train_bwd``."""
    if not fields.is_cuda:
        return blend_train_bwd_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    rows = moment_rows(fields, gidx, counts, col, finT, gc, gtt, basis=True)
    blend_train_bwd_basis.launches += 1
    return reduce_slots(rows, slots, fields.shape[0])


blend_train_fwd.launches = 0
blend_train_bwd.launches = 0
blend_train_bwd_basis.launches = 0
reduce_slots.launches = 0


def check_slots(fields, slots) -> None:
    """A differentiable blend's backward reduces through the binning's
    slots table: raises at the call, not in the backward, when the fields
    need a gradient and the table was not built."""
    if slots is None and fields.requires_grad and torch.is_grad_enabled():
        raise ValueError("a blend whose fields need a gradient needs the binning's slots table "
                         "(bin_gaussians(..., slots=True))")


class BlendTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, gather_idx, counts, slots, bg, H: int, W: int, basis: bool):
        col, finT = blend_train_fwd(fields, gather_idx, counts, bg, H, W)
        ctx.save_for_backward(fields, gather_idx, counts, slots, col, finT)
        ctx.bg_shape = bg.shape
        ctx.basis = basis
        return col, finT

    @staticmethod
    def backward(ctx, gc, gtt):
        fields, gidx, counts, slots, col, finT = ctx.saved_tensors
        gc = gc.contiguous()
        dfields = None
        if ctx.needs_input_grad[0]:
            bwd = blend_train_bwd_basis if ctx.basis else blend_train_bwd
            acc = bwd(fields, gidx, counts, col, finT, gc, gtt.contiguous(), slots)
            dfields = moments_to_dfields(acc, fields)
        dbg = (gc * finT).sum().reshape(ctx.bg_shape)
        return dfields, None, None, None, dbg, None, None, None


def blend_train(fields, gather_idx, counts, slots, bg, H: int, W: int, basis: bool = False):
    """Differentiable training blend: (col, finT), each [H, W].

    fields [P1, 8] from ``stack_fields(pre)``; gather_idx [T, K] int32,
    counts [T] int32 and slots [R, P] int32 from the binning (``None`` only
    when the fields need no gradient); bg [1].  Gradients flow to fields
    (columns 0-5) and bg, through K2, or K6b with ``basis``."""
    check_slots(fields, slots)
    return BlendTrain.apply(fields, gather_idx, counts, slots, bg, H, W, basis)
