"""Parity of the port's training blend (kernels K1/K2 through their plain
versions on the CPU) with ``rasterize_pallas.blend_train`` run in interpret
mode: the forward (col, final T) and the backward (d fields, d bg) of
``jax.vjp``, at 64x64 (even tile columns: the JAX package's paired kernels
K1/K2) and at 64x96 (odd: the unpaired K1u/K6), plus the whole training
render.

The scene piles near-opaque splats on one spot so that the 0.99 alpha clamp
is active and pixels terminate on T (1 - alpha) < 1e-4, and keeps pixels
no splat reaches, which render exactly 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.ops import binning as jbin
from curve_gaussian_tpu.ops import projection as jproj
from curve_gaussian_tpu.ops import rasterize_pallas as jrp
from curve_gaussian_tpu.ops.render import render as jrender

from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops.render import render as prender
from test_torch_port_geometry import assert_close, cam_pair, exact_sort, jax_x64, tt

# per-tile capacity: 136 is a multiple of 8 but not of 16, so the JAX
# backward takes its 8-instance groups (same per-instance arithmetic), which
# interpret mode compiles about 4x faster than the 32-instance ones
K = 136
# float64: summation order only
F64_TOL = 1e-9
# float32 forward: the same operations in the same order; XLA's and
# PyTorch's CPU exp differ in the last ulp, which can flip a gate at a
# threshold pixel, so a few 1e-6
F32_TOL_FWD = 1e-5
# float32 gradients: moment sums in another order over ~1e3 pixels, with
# cancellation between the two signs of D'
F32_TOL_BWD = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


def _scene(seed, P, dtype):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.45, 0.2, P), rng.uniform(-0.45, 0.45, P),
                    rng.uniform(-0.3, 0.3, P)], -1)
    pile = slice(0, 24)  # near-opaque stack: clamp at 0.99 and T termination
    xyz[pile] = [-0.1, 0.05, 0.0] + rng.normal(0, 0.01, size=(24, 3))
    scale = np.stack([rng.uniform(0.02, 0.08, P), rng.uniform(0.004, 0.02, P),
                      rng.uniform(0.004, 0.02, P)], -1)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opa = rng.uniform(0.1, 0.9, P)
    opa[pile] = rng.uniform(0.995, 1.0, 24)
    return [a.astype(dtype) for a in (xyz, scale, q, opa)]


def _case(H, W, dtype, seed=0, P=180):
    """JAX and port inputs of one blend: same preprocessed Gaussians."""
    xyz, scale, q, opa = _scene(seed, P, dtype)
    jc, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W, dtype)
    jpre = jproj.preprocess(*(jnp.asarray(a) for a in (xyz, scale, q, opa)), jc)
    ppre = pproj.Preprocessed(*(tt(a, None) for a in jpre))
    jb = jbin.bin_gaussians(jpre, H, W, capacity=K, big_capacity=64)
    ones = jnp.ones_like(jpre.opacity)
    jfields = jrp.stack_fields(jpre, ones, jnp.zeros((P, 4), ones.dtype),
                               geo=False, invd=False, ones=True)
    rng = np.random.default_rng(seed + 1)
    gc = rng.normal(size=(H, W)).astype(dtype)
    gtt = rng.normal(size=(H, W)).astype(dtype)
    return jpre, ppre, jb, jfields, gc, gtt


def _jax_blend(jb, jfields, gc, gtt, H, W):
    nty, ntx = jbin.tile_grid(H, W)

    def f(fields, bg):
        col, _, finT, _ = jrp.blend_train(fields, jb.gather_idx, jb.idx_pad, jb.counts, bg,
                                          nty, ntx)
        return (jrp.untile_image(col, nty, ntx)[:H, :W],
                jrp.untile_image(finT, nty, ntx)[:H, :W])

    bg = jnp.zeros((1,), jfields.dtype)
    (col, finT), vjp = jax.vjp(f, jfields, bg)
    dfields, dbg = vjp((jnp.asarray(gc), jnp.asarray(gtt)))
    return [np.asarray(a) for a in (col, finT, dfields, dbg)]


# module-level cache: each JAX reference (interpret-mode Pallas) is built once
_REF = {}


def _reference(H, W, dtype):
    key = (H, W, np.dtype(dtype).name)
    if key not in _REF:
        jpre, ppre, jb, jfields, gc, gtt = _case(H, W, dtype)
        _REF[key] = (ppre, jb, np.asarray(jfields), gc, gtt,
                     _jax_blend(jb, jfields, gc, gtt, H, W))
    return _REF[key]


@pytest.mark.parametrize("H,W,dtype", [
    (64, 64, np.float64),   # ntx 2: paired K1/K2
    (64, 96, np.float64),   # ntx 3: unpaired K1u/K6
    (64, 64, np.float32),
])
def test_blend_train_fwd_bwd(H, W, dtype):
    ppre, jb, jfields, gc, gtt, (col, finT, dfields, dbg) = _reference(H, W, dtype)
    fields = prc.stack_fields(ppre)
    assert_close(fields, jfields, 0.0, "stack_fields")
    assert float(finT.min()) < 1e-3, "the scene must terminate pixels on T"
    assert float((col == 0).sum()) > 0, "the scene must leave empty pixels"
    fields = fields.detach().requires_grad_(True)
    bg = torch.zeros(1, dtype=fields.dtype, requires_grad=True)
    gidx = tt(jb.gather_idx, torch.int32)
    counts = tt(jb.counts, torch.int32)
    pcol, pfin = prc.blend_train(fields, gidx, counts, bg, H, W)
    torch.autograd.backward((pcol, pfin), (tt(gc, None), tt(gtt, None)))
    f64 = dtype == np.float64
    assert_close(pcol, col, F64_TOL if f64 else F32_TOL_FWD, "col")
    assert_close(pfin, finT, F64_TOL if f64 else F32_TOL_FWD, "finT")
    assert_close(fields.grad, dfields, F64_TOL if f64 else F32_TOL_BWD, "dfields")
    assert_close(bg.grad, dbg, F64_TOL if f64 else F32_TOL_BWD, "dbg")
    assert prc.blend_train_fwd.launches == 0 and prc.blend_train_bwd.launches == 0


def test_plain_backward_ignores_alpha_clamp():
    """d alpha / d opa is G even where min(0.99, opa G) clamps (as the JAX
    kernels and the original CUDA): autograd through the clamp would give
    0 there."""
    H = W = 64
    ppre, jb, jfields, gc, gtt, (_, _, dfields, _) = _reference(H, W, np.float64)
    fields = prc.stack_fields(ppre)
    P = ppre.opacity.shape[0]
    clamped = fields[:P, 5] > 0.99  # opa G > 0.99 near these splats' centres
    assert bool(clamped.any())
    acc = prc.blend_train_bwd_plain(
        fields, tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32),
        *prc.blend_train_fwd_plain(fields, tt(jb.gather_idx, torch.int32),
                                   tt(jb.counts, torch.int32), torch.zeros(1, dtype=torch.float64),
                                   H, W),
        tt(gc), tt(gtt))
    d_opa = prc.moments_to_dfields(acc, fields)[:, 5]
    assert bool((d_opa[:P][clamped] != 0).any())
    assert_close(d_opa, dfields[:, 5], F64_TOL, "d opa")


def test_training_render_and_clip_tie():
    """render() of the training configuration against the JAX render:
    image and gradients to every input, bg, mean2d_offset and the exposure
    (scale, offset) included.  Empty pixels render exactly 0, where the
    [0, 1] clip passes half the gradient, which d bg shows."""
    H, W, P = 64, 96, 180
    xyz, scale, q, opa = _scene(3, P, np.float64)
    jc, pc = cam_pair([0.0, 0.1, -1.6], [0, 0, 0], H, W)
    rng = np.random.default_rng(5)
    gimg = rng.normal(size=(H, W))
    alive = np.arange(P) % 17 != 0
    expo = np.array([1.3, 0.0])  # offset 0 keeps empty pixels at exactly 0
    kw = dict(render_geo=False, compute_invdepth=False, capacity=K, big_capacity=64)

    def jf(x, s, qq, o, bg, off, ex):
        out = jrender(x, s, qq, o, jc, bg=bg, alive=jnp.asarray(alive), mean2d_offset=off,
                      exposure=ex, **kw)
        return jnp.sum(out["render"] * gimg), out

    args = [jnp.asarray(a) for a in (xyz, scale, q, opa)]
    args += [jnp.zeros(()), jnp.zeros((P, 2)), jnp.asarray(expo)]
    (_, jout), jgrads = jax.value_and_grad(jf, argnums=tuple(range(7)), has_aux=True)(*args)
    pargs = [tt(a).requires_grad_(True) for a in (xyz, scale, q, opa)]
    pbg = torch.zeros((), dtype=torch.float64, requires_grad=True)
    poff = torch.zeros((P, 2), dtype=torch.float64, requires_grad=True)
    pexpo = tt(expo).requires_grad_(True)
    pout = prender(*pargs, pc, bg=pbg, alive=tt(alive, torch.bool), mean2d_offset=poff,
                   exposure=pexpo, **kw)
    (pout["render"] * tt(gimg)).sum().backward()
    img = np.asarray(jout["render"])
    assert (img == 0).sum() > 0 and (img > 0).sum() > 0
    assert_close(pout["render"], img, F64_TOL, "render")
    for k in ("radii", "visibility", "overflow", "tile_peak", "big_peak", "big_overflow"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    for name, t, g in zip(("xyz", "scale", "quat", "opacity", "bg", "mean2d_offset", "exposure"),
                          pargs + [pbg, poff, pexpo], jgrads):
        assert_close(t.grad, np.asarray(g), 1e-8, f"d {name}")
    # the tie rule: d bg = scale * (0.5 sum_empty g T + sum_inside g T)
    empty = img == 0
    gT = gimg * pout["final_T"].detach().numpy()
    want = expo[0] * (0.5 * gT[empty].sum() + gT[(img > 0) & (img < 1)].sum())
    assert abs(float(pbg.grad) - want) < 1e-9
    # the full-channel render (render_geo, invdepth: kernel K3) composites
    # the same ones colour, so its image is the training render's
    with torch.no_grad():
        full = prender(*pargs, pc, bg=pbg, alive=tt(alive, torch.bool), exposure=pexpo,
                       capacity=K, big_capacity=64)
    assert_close(full["render"], img, F64_TOL, "full-channel render")
    assert float(full["alpha"].max()) > 0.5 and float(full["invdepth"].max()) > 0
    assert full["dir"].shape == (3, H, W)
