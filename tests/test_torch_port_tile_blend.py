"""Parity of the port's full-channel blend (kernels K3, K4 and K5 through
their plain versions on the CPU) with ``rasterize_pallas.tile_blend`` and
``tile_blend_indirect`` run in interpret mode, and of ``stack_fields`` with
the JAX one for every channel set.

- (geo, invd, ones) = (T, T, T), the eval render: K3 and K4 against the
  indirect flavor's forward and VJP (d fields, d bg);
- (F, F, T) through the table flavor: K3, and K4's per-slot rows against
  the VJP of the [T, K, NF] payload itself;
- (F, F, T) through the indirect flavor: K3 and K5 (its moment backward);
- (F, F, T) through the table flavor in float32, against the float64
  reference on the same binning.

The JAX references are jitted: an interpret-mode kernel costs seconds to
compile, and eager ``jax.vjp`` would compile the forward twice.

The image is 70x90, so the last tile row and column hold pixels outside
the image, which the kernels leave inactive.  The scene piles near-opaque
splats on one spot, so the 0.99 alpha clamp is active and pixels end on
T (1 - alpha) < 1e-4.  (T, T, F), a per-splat colour, is held through the
whole render in ``test_torch_port_render.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.ops import binning as jbin
from curve_gaussian_tpu.ops import projection as jproj
from curve_gaussian_tpu.ops import rasterize_pallas as jrp
from curve_gaussian_tpu.ops.render import main_axis_allmap as j_main_axis_allmap

from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as ptb
from test_torch_port_blend import _scene
from test_torch_port_cull_cases import slots_table
from test_torch_port_geometry import assert_close, cam_pair, exact_sort, jax_x64, tt

H, W, P = 70, 90, 180
# per-tile capacity: a multiple of 64, since the JAX forward reads its
# instances in groups of 64
K = 128
# float64: summation order only
F64_TOL = 1e-9
# float32 against the float64 reference: the fields' own rounding (~6e-8)
# and a few dozen float32 products and sums per pixel (outputs); the
# per-slot gradients are float32 sums over a tile's 1,024 pixels, with
# cancellation between signs
F32_TOL_FWD = 1e-5
F32_TOL_BWD = 1e-4

SETS = [(g, i, o) for g in (False, True) for i in (False, True) for o in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


def _inputs(dtype, geo, invd, ones, seed=0):
    """JAX fields of a channel set, with the port's Preprocessed, colour,
    allmap and the binning tables: the same Gaussians on both sides."""
    xyz, scale, q, opa = _scene(seed, P, dtype)
    jc, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W, dtype)
    alive = np.arange(P) % 23 != 5  # culled rows: the inverse-depth guard
    jx, jq = jnp.asarray(xyz), jnp.asarray(q)
    jpre = jproj.preprocess(jx, jnp.asarray(scale), jq, jnp.asarray(opa), jc,
                            alive=jnp.asarray(alive))
    color = np.random.default_rng(seed + 7).uniform(0.2, 1.0, P).astype(dtype)
    allmap = j_main_axis_allmap(jx, jq, jc)
    jb = jbin.bin_gaussians(jpre, H, W, capacity=K, big_capacity=64)
    jfields = jrp.stack_fields(jpre, jnp.asarray(color), allmap, geo=geo, invd=invd, ones=ones)
    ppre = pproj.Preprocessed(*(tt(a, None) for a in jpre))
    return jpre, ppre, jb, jfields, color, np.asarray(allmap)


def _cotangents(dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in ((H, W), (H, W), (H, W), (4, H, W))]


def _crop(outs, nty, ntx):
    col, inv, fin, am = outs
    return (jrp.untile_image(col, nty, ntx)[:H, :W], jrp.untile_image(inv, nty, ntx)[:H, :W],
            jrp.untile_image(fin, nty, ntx)[:H, :W], jrp.untile_allmap(am, nty, ntx)[:, :H, :W])


def _vjp(f, x, bg, cots):
    """f's outputs and its VJP to (x, bg) at the cotangents, in one jit."""
    def both(x, b, c):
        outs, vjp = jax.vjp(f, x, b)
        return outs, vjp(c)

    outs, grads = jax.jit(both)(x, bg, tuple(map(jnp.asarray, cots)))
    return [np.asarray(a) for a in outs], [np.asarray(a) for a in grads]


def _jax_indirect(jfields, jb, bg, cots, geo, invd, ones):
    nty, ntx = jbin.tile_grid(H, W)

    def f(fields, b):
        return _crop(jrp.tile_blend_indirect(fields, jb.gather_idx, jb.counts, nty, ntx,
                                             geo, invd, ones, b), nty, ntx)

    return _vjp(f, jfields, bg, cots)


_TABLE = {}


def _jax_table_f64():
    """(F, F, T) inputs in float64 and the table flavor's outputs and VJP of
    the payload table itself (K4's rows) and bg (cached)."""
    if not _TABLE:
        geo, invd, ones = False, False, True
        _, _, jb, jfields, _, _ = _inputs(np.float64, geo, invd, ones)
        cots = _cotangents(np.float64)
        nty, ntx = jbin.tile_grid(H, W)

        def f(pay, b):
            return _crop(jrp.tile_blend(pay, jb.counts, nty, ntx, geo, invd, ones, b), nty, ntx)

        ref, grads = _vjp(f, jfields[jb.gather_idx], jnp.zeros(1), cots)
        _TABLE.update(jb=jb, jfields=np.asarray(jfields), cots=cots, ref=ref, grads=grads)
    return _TABLE


def _port_blend(fields, jb, bg, cots, geo, invd, ones, moment_bwd=False):
    fields = tt(fields, None).requires_grad_(True)
    bg = tt(bg, None).requires_grad_(True)
    gidx, counts = tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32)
    slots = torch.from_numpy(slots_table(gidx, counts, fields.shape[0]))
    outs = ptb.tile_blend(fields, gidx, counts, slots, bg, H, W, geo, invd, ones, moment_bwd)
    dfields, dbg = torch.autograd.grad(outs, (fields, bg), [tt(c, None) for c in cots])
    return outs, dfields, dbg


def _check_outputs(outs, ref, tol, geo, invd):
    for name, o, r in zip(("col", "invd", "finT", "am"), outs, ref):
        assert_close(o, r, tol, name)
    assert float(ref[2].min()) < 1e-3, "the scene must end pixels on T"
    assert (float(np.abs(ref[1]).max()) > 0) == invd and (float(np.abs(ref[3]).max()) > 0) == geo


@pytest.mark.parametrize("geo,invd,ones", SETS)
def test_stack_fields_per_channel_set(geo, invd, ones):
    """The field layout and rows of every channel set, with a double
    ``where`` around the inverse depth: culled rows read 0 and a zero
    cotangent there stays finite where a Gaussian sits at depth 0."""
    jpre, ppre, _, jfields, color, allmap = _inputs(np.float64, geo, invd, ones)
    assert prc.field_layout(geo, invd, ones) == jrp.field_layout(geo, invd, ones)
    fields = prc.stack_fields(ppre, tt(color), tt(allmap), geo=geo, invd=invd, ones=ones)
    assert_close(fields, jfields, 0.0, "stack_fields")
    assert fields.shape[0] % 8 == 0 and fields.shape[0] > P
    if invd:
        L, _ = prc.field_layout(geo, invd, ones)
        assert not bool(ppre.valid.all()) and bool((fields[:P][~ppre.valid, L["invd"]] == 0).all())
        depth = ppre.depth.clone().requires_grad_(True)
        culled = torch.where(ppre.valid, depth, torch.zeros_like(depth))
        f = prc.stack_fields(ppre._replace(depth=culled), tt(color), tt(allmap), geo=geo,
                             invd=True, ones=ones)
        (g,) = torch.autograd.grad(f[:P, L["invd"]].sum(), depth)
        assert bool(torch.isfinite(g).all()) and bool((g[~ppre.valid] == 0).all())
    if (geo, invd, ones) == (False, False, True):
        assert torch.equal(fields, prc.stack_fields(ppre)), "the training call is unchanged"


def test_k3_k4_eval_channels():
    """(T, T, T), the eval render's channel set: K3 and K4 against
    ``tile_blend_indirect``'s forward and VJP."""
    geo, invd, ones = True, True, True
    _, _, jb, jfields, _, _ = _inputs(np.float64, geo, invd, ones)
    cots = _cotangents(np.float64)
    bg = np.array([0.25])
    ref, (dfields, dbg) = _jax_indirect(jfields, jb, jnp.asarray(bg), cots, geo, invd, ones)
    outs, pdf, pdbg = _port_blend(jfields, jb, bg, cots, geo, invd, ones)
    _check_outputs(outs, ref, F64_TOL, geo, invd)
    assert_close(pdf, dfields, F64_TOL, "d fields")
    assert_close(pdbg, dbg, F64_TOL, "d bg")
    assert float(np.abs(dfields[:, 6:11]).max()) > 0, "the channel fields get gradients"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k3_k4_training_channels_table(dtype):
    """(F, F, T) through the table flavor: K3's outputs, and K4's per-slot
    rows against the VJP of the payload table (slots past a tile's early
    exit read zero on both sides), then their reduction to Gaussians.  The
    float32 case runs the port on the float64 case's fields and binning,
    rounded to float32, against the float64 reference."""
    geo, invd, ones = False, False, True
    t = _jax_table_f64()
    jb, ref, (dpay, dbg) = t["jb"], t["ref"], t["grads"]
    jfields, cots = t["jfields"].astype(dtype), [c.astype(dtype) for c in t["cots"]]
    bg = np.array([0.0], dtype)
    f64 = dtype == np.float64
    gidx, counts = tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32)
    fields = tt(jfields, None)
    outs = ptb.tile_blend_fwd(fields, gidx, counts, tt(bg, None), H, W, geo, invd, ones)
    _check_outputs(outs, ref, F64_TOL if f64 else F32_TOL_FWD, geo, invd)
    rows = ptb.tile_blend_bwd(fields, gidx, counts, outs, tuple(tt(c, None) for c in cots),
                              geo, invd, ones)
    assert_close(rows, dpay, F64_TOL if f64 else F32_TOL_BWD, "per-slot d fields")
    assert float(np.abs(dpay[:, :, 5]).max()) > 0
    _, pdf, pdbg = _port_blend(jfields, jb, bg, cots, geo, invd, ones)
    want = np.zeros(jfields.shape)
    np.add.at(want, np.asarray(jb.gather_idx).reshape(-1), dpay.reshape(-1, dpay.shape[-1]))
    assert_close(pdf, want, F64_TOL if f64 else F32_TOL_BWD, "d fields")
    assert_close(pdbg, dbg, F64_TOL if f64 else F32_TOL_BWD, "d bg")


def test_k3_k5_training_channels_indirect():
    """(F, F, T) through the indirect flavor: K3, and K5's per-slot moments
    through ``moments_to_dfields`` against the moment backward's VJP."""
    geo, invd, ones = False, False, True
    _, _, jb, jfields, _, _ = _inputs(np.float64, geo, invd, ones, seed=2)
    cots = _cotangents(np.float64, seed=3)
    bg = np.array([0.1])
    ref, (dfields, dbg) = _jax_indirect(jfields, jb, jnp.asarray(bg), cots, geo, invd, ones)
    outs, pdf, pdbg = _port_blend(jfields, jb, bg, cots, geo, invd, ones, moment_bwd=True)
    _check_outputs(outs, ref, F64_TOL, geo, invd)
    assert_close(pdf, dfields, F64_TOL, "d fields")
    assert_close(pdbg, dbg, F64_TOL, "d bg")
    gidx, counts = tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32)
    mom = ptb.blend_moment_bwd(tt(jfields, None), gidx, counts, outs[0].detach(),
                               outs[2].detach(), tt(cots[0], None), tt(cots[2], None))
    assert mom.shape == tuple(jb.gather_idx.shape) + (8,)
    n = np.asarray(jb.counts)
    past = np.arange(K)[None, :] >= n[:, None]
    assert bool((mom[torch.as_tensor(past)] == 0).all()), "empty slots read zero"
    assert ptb.tile_blend_fwd.launches == ptb.tile_blend_bwd.launches == 0
    assert ptb.blend_moment_bwd.launches == 0
