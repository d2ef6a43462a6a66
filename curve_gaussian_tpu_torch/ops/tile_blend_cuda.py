"""Full-channel tile blend: kernels K3 (forward), K4 (backward) and K5 (the
moment backward of the training channel set).

The counterpart of ``tile_blend`` / ``tile_blend_indirect`` in
``curve_gaussian_tpu/ops/rasterize_pallas.py``, for every channel set
(geo, invd, ones): the colour (ones, or a per-splat colour field), the
expected inverse depth, the four allmap channels (view-space main axis and
alpha) and the final transmittance.

K3 ``tile_blend_fwd`` replaces ``_make_fwd_kernel(geo, invd, ones,
indirect)``: the compositing of ``rasterize_cuda`` (K1 is its training
instantiation), accumulating C_c += ch_c alpha T for each channel; with
ones colour the colour is 1 - T (1 - bg), else C_col + T bg.  Gated
channels read zero (the kernel writes them).

K4 ``tile_blend_bwd`` replaces ``_make_bwd_kernel(geo, invd, ones,
indirect)``: one front-to-back pass with an inclusive prefix A_c per
channel gives
g_alpha = gt (-finT / (1 - alpha)) + sum_c g_c (ch_c T_i - (O_c - A_c) / (1 - alpha)),
and the gradients of all fields of each instance slot, reduced over the
tile's pixels, land in a [T, K, NF] table.

K5 ``blend_moment_bwd`` replaces ``_make_bwd_moment_kernel(indirect=True)``:
K2's kernel, its moments per slot in [T, K, 8], which ``moments_to_dfields``
maps to field gradients after the slot -> Gaussian reduction.

K4 and K5 sum each slot's row over the tile's pixels in a fixed order
(warp, warp index, quarter block), and the reduction of their tables to
Gaussians is the ``reduce_slots`` kernel through the binning's ``slots``
(each Gaussian's slots in (tile, slot) order), where the JAX package leaves
a scatter-add to XLA: the same inputs give the same bits on every launch.
The plain versions reduce with ``index_add_``.  The derivative of alpha
ignores the 0.99 clamp (d alpha / d opa = G), so every backward here is
the hand-derived formula, never autograd through the clamp.

Every wrapper takes the plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.  See ``csrc/tile_blend.cu`` for
what bounds the kernels and what their design does about it.
"""
from __future__ import annotations

import torch

from .. import _build
from .binning import tile_grid
from .rasterize_cuda import (
    _check_bg,
    _check_tables,
    _composite_step,
    _from_tiles,
    _lib,
    _pixels,
    _reduce_rows,
    _to_tiles,
    bwd_scratch,
    check_slots,
    field_layout,
    moment_rows,
    moment_rows_plain,
    moments_to_dfields,
    reduce_slots,
)


def channels(geo: bool, invd: bool, ones: bool):
    """[(channel name, field column or None)] in channel order: the colour
    (no field with ones colour), [invd], [am0..am3]."""
    L, _ = field_layout(geo, invd, ones)
    names = ["col"] + (["invd"] if invd else []) + ([f"am{i}" for i in range(4)] if geo else [])
    return [(n, L.get(n)) for n in names]


def _unpack(chan_imgs, geo: bool, invd: bool):
    """Per-channel [H, W] images in channel order from (col, invd, am)."""
    col, inv, am = chan_imgs
    return [col] + ([inv] if invd else []) + ([am[i] for i in range(4)] if geo else [])


def tile_blend_fwd_plain(fields, gidx, counts, bg, H: int, W: int,
                         geo: bool, invd: bool, ones: bool):
    """Plain PyTorch K3: (col, invd, finT) [H, W] and am [4, H, W]."""
    nty, ntx = tile_grid(H, W)
    px, py = _pixels(nty, ntx, fields.dtype, fields.device)
    pay = fields[gidx.long()]  # [T, K, NF]
    acc_cols = [c for _, c in channels(geo, invd, ones) if c is not None]
    T = torch.ones_like(px)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    zero = torch.zeros_like(px)
    accs = [zero] * len(acc_cols)
    for j in range(int(counts.max()) if counts.numel() else 0):
        f = pay[:, j]
        Ti = T
        _, ag, _, _, contrib, T, act = _composite_step(f, px, py, T, act)
        w = torch.where(contrib, ag * Ti, zero)
        accs = [a + f[:, c : c + 1] * w for a, c in zip(accs, acc_cols)]
    by = dict(zip([n for n, c in channels(geo, invd, ones) if c is not None], accs))
    bgv = bg.reshape(())
    col = 1.0 - T * (1.0 - bgv) if ones else by["col"] + T * bgv
    out = [col, by.get("invd", zero), T] + [by.get(f"am{i}", zero) for i in range(4)]
    img = [_from_tiles(x, nty, ntx, H, W) for x in out]
    return img[0], img[1], img[2], torch.stack(img[3:])


def tile_blend_bwd_plain(fields, gidx, counts, outs, cots, geo: bool, invd: bool, ones: bool):
    """Plain PyTorch K4: per-slot field gradients [T, K, NF].

    outs = (col, invd, finT, am) of the forward, cots their cotangents."""
    col, inv, finT, am = outs
    gcol, ginv, gfin, gam = cots
    H, W = col.shape
    nty, ntx = tile_grid(H, W)
    _, nf = field_layout(geo, invd, ones)
    chans = channels(geo, invd, ones)
    px, py = _pixels(nty, ntx, fields.dtype, fields.device)
    pay = fields[gidx.long()]
    och = [_to_tiles(x, nty, ntx) for x in _unpack((col, inv, am), geo, invd)]
    gch = [_to_tiles(x, nty, ntx) for x in _unpack((gcol, ginv, gam), geo, invd)]
    gt, ot = _to_tiles(gfin, nty, ntx), _to_tiles(finT, nty, ntx)
    T = torch.ones_like(px)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    zero = torch.zeros_like(px)
    A = [zero] * len(chans)
    dpay = fields.new_zeros(gidx.shape + (nf,))
    for j in range(int(counts.max()) if counts.numel() else 0):
        f = pay[:, j]
        mx, my, ca, cb, cc, opa = (f[:, i : i + 1] for i in range(6))
        Ti = T
        G, ag, dx, dy, contrib, T, act = _composite_step(f, px, py, T, act)
        w = torch.where(contrib, ag * Ti, zero)
        chv = [Ti.new_ones(()) if c is None else f[:, c : c + 1] for _, c in chans]
        inv1a = 1.0 / (1.0 - ag)
        ga = gt * (-ot * inv1a)
        for i in range(len(chans)):
            A[i] = A[i] + chv[i] * w
            ga = ga + gch[i] * (chv[i] * Ti - (och[i] - A[i]) * inv1a)
        ga = torch.where(contrib, ga, zero)
        dpow = ga * (opa * G)
        vals = [
            dpow * (-ca * dx - cb * dy),
            dpow * (-cc * dy - cb * dx),
            dpow * (-0.5 * dx * dx),
            dpow * (-dx * dy),
            dpow * (-0.5 * dy * dy),
            ga * G,
        ] + [g * w for g, (_, c) in zip(gch, chans) if c is not None]
        dpay[:, j, : len(vals)] = torch.stack(vals, dim=-1).sum(dim=1)
    return dpay


# Plain PyTorch K5: K2's per-slot moments [T, K, 8] before their reduction
blend_moment_bwd_plain = moment_rows_plain


def _check_fields(fields, gidx, counts, H: int, W: int, nf: int):
    nty, ntx = _check_tables(fields, gidx, counts, H, W, nf)
    if fields.data_ptr() % 16:
        raise ValueError("fields must start on a 16-byte boundary (the kernels read float4)")
    return nty, ntx


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def tile_blend_fwd(fields, gidx, counts, bg, H: int, W: int, geo: bool, invd: bool, ones: bool):
    """K3: (col, invd, finT) [H, W] and am [4, H, W].  fields [P1, NF]
    float32 from ``stack_fields`` with this channel set, gidx [T, K] int32
    with sentinel P in empty slots, counts [T] int32, bg [1]."""
    if not fields.is_cuda:
        return tile_blend_fwd_plain(fields, gidx, counts, bg, H, W, geo, invd, ones)
    _, nf = field_layout(geo, invd, ones)
    nty, ntx = _check_fields(fields, gidx, counts, H, W, nf)
    bg = _check_bg(bg, fields.device)
    # the kernel writes every output, the zeros of a channel the set lacks too
    col = torch.empty((H, W), dtype=torch.float32, device=fields.device)
    finT = torch.empty_like(col)
    inv = torch.empty_like(col)
    am = torch.empty((4, H, W), dtype=torch.float32, device=fields.device)
    lib = _lib()
    code = lib.tile_blend_fwd(
        fields.data_ptr(), gidx.data_ptr(), counts.data_ptr(), bg.data_ptr(), col.data_ptr(),
        inv.data_ptr(), finT.data_ptr(), am.data_ptr(), H, W, nty, ntx, gidx.shape[1],
        int(geo), int(invd), int(ones), _stream(fields),
    )
    _build.check(lib, code, "tile_blend_fwd")
    tile_blend_fwd.launches += 1
    return col, inv, finT, am


def tile_blend_bwd(fields, gidx, counts, outs, cots, geo: bool, invd: bool, ones: bool):
    """K4: per-slot field gradients [T, K, NF] from the forward's outputs
    outs = (col, invd, finT, am) and their cotangents cots (same shapes);
    slots a tile never reached read zero."""
    if not fields.is_cuda:
        return tile_blend_bwd_plain(fields, gidx, counts, outs, cots, geo, invd, ones)
    H, W = outs[0].shape
    L, nf = field_layout(geo, invd, ones)
    nty, ntx = _check_fields(fields, gidx, counts, H, W, nf)
    for name, t in zip(("col", "invd", "finT", "am", "g col", "g invd", "g finT", "g am"),
                       outs + cots):
        shape = (4, H, W) if name.endswith("am") else (H, W)
        if t.dtype != torch.float32 or t.shape != shape or t.device != fields.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on "
                             f"{fields.device}")
    qrows, tickets = bwd_scratch(gidx, len(L))  # one row value per field of the set
    dpay = torch.empty(gidx.shape + (nf,), dtype=torch.float32, device=fields.device)
    lib = _lib()
    code = lib.tile_blend_bwd(
        fields.data_ptr(), gidx.data_ptr(), counts.data_ptr(),
        *(t.data_ptr() for t in outs + cots), qrows.data_ptr(), tickets.data_ptr(),
        dpay.data_ptr(), H, W, nty, ntx, gidx.shape[1], int(geo), int(invd), int(ones),
        _stream(fields),
    )
    _build.check(lib, code, "tile_blend_bwd")
    tile_blend_bwd.launches += 1
    return dpay


def blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt):
    """K5: per-slot moments [T, K, 8] (columns 0-5) of the training channel
    set from the forward's col/finT and the cotangents gc and gtt, all
    [H, W]; slots a tile never reached read zero."""
    if not fields.is_cuda:
        return blend_moment_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    mom = moment_rows(fields, gidx, counts, col, finT, gc, gtt)
    blend_moment_bwd.launches += 1
    return mom


tile_blend_fwd.launches = 0
tile_blend_bwd.launches = 0
blend_moment_bwd.launches = 0


def _to_gaussians(fields, gidx, rows, slots):
    """Slot rows [T, K, NF] -> per-Gaussian rows [P1, NF]: ``reduce_slots``
    on the card, ``index_add_`` (the plain versions') on the CPU."""
    if rows.is_cuda:
        return reduce_slots(rows, slots, fields.shape[0])
    return _reduce_rows(fields, gidx, rows)


class TileBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, gather_idx, counts, slots, bg, H: int, W: int, geo: bool,
                invd: bool, ones: bool, moment_bwd: bool):
        outs = tile_blend_fwd(fields, gather_idx, counts, bg, H, W, geo, invd, ones)
        ctx.save_for_backward(fields, gather_idx, counts, slots, *outs)
        ctx.cfg = (geo, invd, ones, moment_bwd)
        ctx.bg_shape = bg.shape
        return outs

    @staticmethod
    def backward(ctx, gc, gd, gtt, gam):
        fields, gidx, counts, slots, *outs = ctx.saved_tensors
        geo, invd, ones, moment_bwd = ctx.cfg
        cots = tuple(g.contiguous() for g in (gc, gd, gtt, gam))
        dfields = None
        if ctx.needs_input_grad[0]:
            if moment_bwd and ones and not geo and not invd:
                mom = blend_moment_bwd(fields, gidx, counts, outs[0], outs[2], cots[0], cots[2])
                dfields = moments_to_dfields(_to_gaussians(fields, gidx, mom, slots), fields)
            else:
                dpay = tile_blend_bwd(fields, gidx, counts, tuple(outs), cots, geo, invd, ones)
                dfields = _to_gaussians(fields, gidx, dpay, slots)
        dbg = (cots[0] * outs[2]).sum().reshape(ctx.bg_shape)
        return dfields, None, None, None, dbg, None, None, None, None, None, None


def tile_blend(fields, gather_idx, counts, slots, bg, H: int, W: int, geo: bool, invd: bool,
               ones: bool, moment_bwd: bool = False):
    """Differentiable full-channel blend: (col, invd, finT) [H, W] and am
    [4, H, W].

    fields [P1, NF] from ``stack_fields`` with the same (geo, invd, ones);
    gather_idx [T, K] int32, counts [T] int32 and slots [R, P] int32 from
    the binning (``None`` only when the fields need no gradient); bg [1].
    The backward is K4, or K5 when ``moment_bwd`` is set and the channel set
    is the training one (ones colour, no geo, no invd).  Gradients flow to
    fields and bg."""
    check_slots(fields, slots)
    return TileBlend.apply(fields, gather_idx, counts, slots, bg, H, W, geo, invd, ones,
                           moment_bwd)
