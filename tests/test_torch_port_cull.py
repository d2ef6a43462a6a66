"""The cull of the training blend kernels K1 and K2: each warp skips the
instances whose ``support_box`` misses its pixels, which is exact only if
no pixel outside an instance's box can pass the gate.

- The box (``rasterize_cuda.support_box``, the float32 mirror of the
  kernels' box in its order of operations) is conservative over the
  seeded families of ``test_torch_port_cull_cases``: thin, wide,
  axis-aligned, rotated and near-degenerate conics, opacities near 1/255
  and near 1, means outside the 64x64 neighbourhood checked, and pixels
  placed where the box touches the ellipse.  Every pixel where the float64 gate
  passes to within 1e-5 relative, and every pixel where the float32 gate of
  the plain pass passes, lies inside the box.
- A culled plain pass (``_composite_step`` with the pairs outside the box
  forced to non-candidates, as the kernels skip them) gives the plain
  forward and the plain moment rows bitwise, on a small scene that clamps
  alpha and ends pixels on T, and on the bench configuration's binning
  (3,375 seed curves x 12 Gaussians at 512x512) cut to the 2x2 tiles
  around its longest list; and it matches the JAX package's oracle
  (``rasterize_ref.rasterize_reference`` and its VJP) in float64 within
  the blend tests' 1e-9.
- The full-channel kernels K3 and K4 take the same cull for every channel
  set (the box reads only the six geometry fields): the culled plain
  forward and per-slot rows of each of the eight sets equal the unculled
  ones bitwise on the small scene.  K5 and K6b take it too: K5's rows are
  the moment rows above, and K6b's rows (raw tile-local sums, then their
  recombination per slot) equal the unculled ones bitwise on both scenes.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from curve_gaussian_tpu.ops.projection import Preprocessed as JPre
from curve_gaussian_tpu.ops.rasterize_ref import rasterize_reference

from curve_gaussian_tpu_torch.config import PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as ptb
from curve_gaussian_tpu_torch.ops.binning import bin_gaussians, tile_grid
from curve_gaussian_tpu_torch.ops.projection import preprocess
from curve_gaussian_tpu_torch.ops.rasterize_ref import ALPHA_EPS
from test_torch_port_blend import F64_TOL, _case
from test_torch_port_cull_cases import FAMILIES, N, NB, family_rows
from test_torch_port_geometry import assert_close, exact_sort, jax_x64, tt


@pytest.fixture(scope="module", autouse=True)
def _x64_exact():
    with jax_x64(), exact_sort():
        yield


# -- (a) the box is conservative --------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_support_box_is_conservative(family):
    f32 = family_rows(family)
    box = prc.support_box(f32)
    p = torch.arange(NB * NB)
    px = (p % NB).to(torch.float64)[None, :]
    py = (p // NB).to(torch.float64)[None, :]
    inside = ((px >= box[:, 0:1]) & (px <= box[:, 1:2]) & (py >= box[:, 2:3])
              & (py <= box[:, 3:4]))
    # the float64 gate on the same float32 values, within 1e-5 relative
    f = f32.double()
    mx, my, ca, cb, cc, op = (f[:, i : i + 1] for i in range(6))
    dx, dy = mx - px, my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    gate64 = (power <= 0.0) & (op * torch.exp(power) >= ALPHA_EPS * (1.0 - 1e-5))
    bad = gate64 & ~inside
    assert not bool(bad.any()), f"{int(bad.any(dim=1).sum())} boxes miss float64-gate pixels"
    # the float32 gate of the plain pass (the kernels' arithmetic)
    one = torch.ones((N, NB * NB))
    _, _, _, _, cand32, _, _ = prc._composite_step(f32, px.float(), py.float(), one,
                                                   one.bool())
    bad32 = cand32 & ~inside
    assert not bool(bad32.any()), f"{int(bad32.any(dim=1).sum())} boxes miss float32-gate pixels"
    assert int(gate64.sum()) > 0 or family == "means_outside"
    if family == "tangent":
        assert float(gate64[:, NB // 2 * NB + NB // 2].double().mean()) > 0.8
    # and tight: where ca cc / det <= 1e3 (the lowered det costs at most
    # 0.2% of width; the bench shape's conics stay below 1.1), a box is at
    # most 1% and 1.5 px wider than the ellipse -power <= t + BOX_T_SLACK
    det = (ca * cc - cb * cb)[:, 0]
    t = torch.log(255.0 * op[:, 0]).clamp(min=0.0) + prc.BOX_T_SLACK
    hx = torch.sqrt(2.0 * t * cc[:, 0] / det)
    fin = torch.isfinite(box).all(dim=1) & (box[:, 0] <= box[:, 1])
    mild = fin & ((ca * cc)[:, 0] / det <= 1e3)
    if family != "near_degenerate":
        assert float(fin.double().mean()) > 0.95 and float(mild.double().mean()) > 0.3
        half = 0.5 * (box[:, 1] - box[:, 0]).double()
        assert bool((half[mild] <= hx[mild] * 1.01 + 1.5).all())


# -- (b) the culled plain pass is exact ----------------------------------------


def _culled_step(step):
    """``_composite_step`` that forces every pair outside its instance's
    support box to a non-candidate (zero opacity at that pixel), as the
    kernels never evaluate it."""

    def culled(f, px, py, T, act):
        box = prc.support_box(f).to(px.dtype)
        inside = ((px >= box[:, 0:1]) & (px <= box[:, 1:2]) & (py >= box[:, 2:3])
                  & (py <= box[:, 3:4]))
        fp = f[:, :, None].expand(-1, -1, px.shape[1]).clone()
        fp[:, 5] = torch.where(inside, fp[:, 5], torch.zeros_like(fp[:, 5]))
        culled.outside += int((act & ~inside).sum())
        culled.live += int(act.sum())
        out = step(fp, px[:, None], py[:, None], T[:, None], act[:, None])
        return tuple(o[:, 0] for o in out)

    culled.outside = culled.live = 0
    return culled


@functools.lru_cache(maxsize=None)
def _small_case():
    H = W = 64
    _, ppre, jb, _, gc, gtt = _case(H, W, np.float64)
    return ppre, tt(jb.gather_idx, torch.int32), tt(jb.counts, torch.int32), H, W, tt(gc), tt(gtt)


def _small():
    ppre, gidx, counts, H, W, gc, gtt = _small_case()
    return prc.stack_fields(ppre), ppre.depth, gidx, counts, H, W, gc, gtt


_BENCH = {}


def _bench_cut():
    """The bench configuration's first view, binned as the main path bins
    it (exact depth order), cut to the 2x2 tiles around its longest list:
    means shifted to the cut's origin, a 64x64 image."""
    if not _BENCH:
        H = W = 512
        cam = synthetic.ring_cameras(4, H, W, device="cpu")[0]
        st = pcs.init_state(synthetic.grid_seed_points(15), n_views=4, n_gaussians=12,
                            device="cpu")
        pipe = PipelineConfig()
        with torch.no_grad():
            g = pcs.gaussians(st)
            pre = preprocess(g["xyz"], g["scale"], g["quat"], g["opacity"], cam,
                             alive=g["alive"])
            b = bin_gaussians(pre, H, W, capacity=pipe.tile_capacity,
                              big_capacity=pipe.big_capacity)
        nty, ntx = tile_grid(H, W)
        top = int(b.counts.argmax())
        ty0, tx0 = min(top // ntx, nty - 2), min(top % ntx, ntx - 2)
        tiles = [(ty0 + a) * ntx + tx0 + c for a in (0, 1) for c in (0, 1)]
        fields = prc.stack_fields(pre).detach().clone()
        fields[:, 0] -= 32.0 * tx0
        fields[:, 1] -= 32.0 * ty0
        rng = np.random.default_rng(7)
        gc = torch.tensor(rng.normal(size=(64, 64)), dtype=torch.float32)
        gtt = torch.tensor(rng.normal(size=(64, 64)), dtype=torch.float32)
        pad = torch.zeros(fields.shape[0] - pre.depth.shape[0])
        _BENCH["cut"] = (fields, torch.cat([pre.depth.detach(), pad]),
                         b.gather_idx[tiles].contiguous(), b.counts[tiles].contiguous(), 64, 64,
                         gc, gtt)
        assert int(b.counts.max()) > 600  # the longest list of the bench shape
    return _BENCH["cut"]


SCENES = {"small": _small, "bench_cut": _bench_cut}


def _plain(fields, gidx, counts, H, W, gc, gtt):
    bg = torch.zeros(1, dtype=fields.dtype)
    col, finT = prc.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    mom = prc.moment_rows_plain(fields, gidx, counts, col, finT, gc, gtt)
    return col, finT, mom


@pytest.mark.parametrize("scene", list(SCENES))
def test_culled_pass_equals_plain_bitwise(monkeypatch, scene):
    fields, _, gidx, counts, H, W, gc, gtt = SCENES[scene]()
    gc, gtt = gc.to(fields.dtype), gtt.to(fields.dtype)
    want = _plain(fields, gidx, counts, H, W, gc, gtt)
    culled = _culled_step(prc._composite_step)
    monkeypatch.setattr(prc, "_composite_step", culled)
    got = _plain(fields, gidx, counts, H, W, gc, gtt)
    for name, a, b in zip(("col", "finT", "moment rows"), got, want):
        assert torch.equal(a, b), name
    # the cull skips most live pairs, so the equality says something
    assert culled.outside > 0.5 * culled.live, (culled.outside, culled.live)
    assert float(want[1].min()) < 0.5 and float(want[2].abs().max()) > 0


@pytest.mark.parametrize("scene", list(SCENES))
def test_culled_basis_rows_equal_plain_bitwise(monkeypatch, scene):
    """K6b's cull: ``moment_rows_basis_plain`` with the pairs outside the
    box skipped equals the unculled rows, which are not all zero."""
    fields, _, gidx, counts, H, W, gc, gtt = SCENES[scene]()
    gc, gtt = gc.to(fields.dtype), gtt.to(fields.dtype)
    bg = torch.zeros(1, dtype=fields.dtype)
    col, finT = prc.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    want = prc.moment_rows_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    culled = _culled_step(prc._composite_step)
    monkeypatch.setattr(prc, "_composite_step", culled)
    got = prc.moment_rows_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    assert torch.equal(got, want)
    assert culled.outside > 0.5 * culled.live, (culled.outside, culled.live)
    assert float(want.abs().max()) > 0


def _jax_reference(fields, depth, gidx, counts, H, W, gc, gtt):
    """The JAX oracle on the listed Gaussians of (gidx, counts), in depth
    order with the lists as tile membership: (col, finT, d fields [P1, 6])."""
    nt, K = gidx.shape
    listed = torch.arange(K)[None, :] < counts[:, None]
    ids = torch.unique(gidx[listed].long())
    member = np.zeros((ids.numel(), nt), bool)
    pos = {int(g): i for i, g in enumerate(ids)}
    for t in range(nt):
        for g in gidx[t, : int(counts[t])].tolist():
            member[pos[g], t] = True
    f = fields[ids].numpy()
    n = ids.numel()
    base = JPre(mean2d=jnp.asarray(f[:, 0:2]), conic=jnp.asarray(f[:, 2:5]),
                depth=jnp.asarray(depth[ids].double().numpy()), opacity=jnp.asarray(f[:, 5]),
                radius=jnp.ones(n, jnp.int32), extent=jnp.ones((n, 2)),
                valid=jnp.ones(n, bool))

    def render(mean2d, conic, opacity):
        out = rasterize_reference(base._replace(mean2d=mean2d, conic=conic, opacity=opacity),
                                  jnp.ones(n), jnp.zeros((n, 4)), 0.0, H, W,
                                  render_geo=False, member=jnp.asarray(member))
        return out["render"], out["final_T"]

    (col, finT), vjp = jax.vjp(render, base.mean2d, base.conic, base.opacity)
    dm, dc, do = vjp((jnp.asarray(gc.numpy()), jnp.asarray(gtt.numpy())))
    d = np.zeros((fields.shape[0], 6))
    d[ids.numpy()] = np.concatenate([np.asarray(dm), np.asarray(dc), np.asarray(do)[:, None]], 1)
    return np.asarray(col), np.asarray(finT), d


@pytest.mark.parametrize("scene", list(SCENES))
def test_culled_pass_matches_jax_oracle(monkeypatch, scene):
    fields, depth, gidx, counts, H, W, gc, gtt = SCENES[scene]()
    fields, gc, gtt = fields.double(), gc.double(), gtt.double()
    monkeypatch.setattr(prc, "_composite_step", _culled_step(prc._composite_step))
    col, finT, mom = _plain(fields, gidx, counts, H, W, gc, gtt)
    dfields = prc.moments_to_dfields(prc._reduce_rows(fields, gidx, mom), fields)[:, :6]
    jcol, jfin, jd = _jax_reference(fields, depth, gidx, counts, H, W, gc, gtt)
    assert_close(col, jcol, F64_TOL, "col")
    assert_close(finT, jfin, F64_TOL, "finT")
    assert_close(dfields, jd, F64_TOL, "d fields")


CHANNEL_SETS = [(g, i, o) for g in (False, True) for i in (False, True) for o in (False, True)]


@pytest.mark.parametrize("geo,invd,ones", CHANNEL_SETS)
def test_culled_full_channel_pass_equals_plain_bitwise(monkeypatch, geo, invd, ones):
    """K3/K4's cull on the small scene, float32 as the kernels: the plain
    forward (col, invd, finT, am) and per-slot rows of the channel set with
    the pairs outside the training box skipped equal the unculled ones."""
    ppre, gidx, counts, H, W, gc, gtt = _small_case()
    rng = np.random.default_rng(11)
    P = ppre.opacity.shape[0]
    color, allmap = tt(rng.uniform(0.2, 1.0, P)), tt(rng.normal(size=(P, 4)))
    fields = prc.stack_fields(ppre, color, allmap, geo=geo, invd=invd, ones=ones).float()
    cots = (gc.float(), tt(rng.normal(size=(H, W))).float(), gtt.float(),
            tt(rng.normal(size=(4, H, W))).float())
    bg = torch.full((1,), 0.25)

    def blend():
        outs = ptb.tile_blend_fwd_plain(fields, gidx, counts, bg, H, W, geo, invd, ones)
        return outs + (ptb.tile_blend_bwd_plain(fields, gidx, counts, outs, cots, geo, invd,
                                                ones),)

    want = blend()
    culled = _culled_step(ptb._composite_step)
    monkeypatch.setattr(ptb, "_composite_step", culled)
    got = blend()
    for name, a, b in zip(("col", "invd", "finT", "am", "per-slot rows"), got, want):
        assert torch.equal(a, b), name
    # the cull skips most live pairs, and every output of the set is live
    assert culled.outside > 0.5 * culled.live, (culled.outside, culled.live)
    assert float(want[2].min()) < 0.5 and float(want[4].abs().max()) > 0
    assert (float(want[1].abs().max()) > 0) == invd and (float(want[3].abs().max()) > 0) == geo
