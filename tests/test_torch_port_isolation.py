"""The port stands alone: no module of ``curve_gaussian_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package, PIL or matplotlib, entry points run on the
card unless the caller asks for the CPU, and the kernel wrappers launch
nothing for CPU tensors.  The last three tests need a CUDA card: they hold
every kernel against its plain version there, K7/K8 at shapes ragged
against their tiles, and the cull of K1-K6b over the conics that stress its
box (``pytest --noconftest -m cuda tests/test_torch_port_isolation.py``)."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import curve_gaussian_tpu_torch
from curve_gaussian_tpu_torch import _build, convert
from curve_gaussian_tpu_torch import train as ptrain_cli
from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import dataset, synthetic
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import camera as pcam
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops import ssim_cuda as psc
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as ptb
from curve_gaussian_tpu_torch.scripts import run_batch_abc
from curve_gaussian_tpu_torch.scripts.make_ref_scale_scene import make_ref_scale_scene
from curve_gaussian_tpu_torch.scripts.render_curves import render_curves
from test_torch_port_cull_cases import FAMILIES, packed_family

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "curve_gaussian_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "curve_gaussian_tpu", "PIL", "matplotlib")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="curve_gaussian_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert len(mods) >= 35 and "curve_gaussian_tpu_torch.ops.tile_blend_cuda" in mods, mods
    for m in ("engine.loop", "engine.checkpoint", "models.surgery", "models.fitting",
              "eval.extract", "eval.metrics", "data.ply", "models.ellipsoids",
              "models.gaussian_ply", "train", "data.colmap", "data.png", "data.dataset",
              "scripts.make_ref_scale_scene", "ops.sh", "eval.abc", "eval.replica",
              "scripts.render_curves", "scripts.run_batch_abc", "scripts.eval_gt_json"):
        assert f"curve_gaussian_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr


def test_no_source_names_jax():
    """Static check of every source, chip_smoke.py included (an import
    inside a function would escape the runtime check above)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{f}: imports {n}"


def test_entry_points_default_to_the_card():
    """Without device='cpu' an entry point raises where CUDA is absent; it
    never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the entry points run on the card")
    pts = np.random.default_rng(0).uniform(size=(5, 3))
    calls = [
        lambda: pcs.init_state(pts, n_views=1),
        lambda: synthetic.ring_cameras(1, 32, 32),
        lambda: pcam.look_at_camera([0, 0, -2.0], [0, 0, 0]),
        lambda: synthetic.make_scene(n_views=1, height=32, width=32),
        lambda: convert.state_from_numpy(
            {k: np.zeros((2, 1)) for k in pcs.TRAINABLE_FIELDS}, [True] * 2, [True] * 2),
        lambda: curve_gaussian_tpu_torch.resolve_device(),
        lambda: ploop.train_scene([], [], pts, ModelConfig(), OptimizationConfig(),
                                  PipelineConfig(), "unused"),
        lambda: ptrain_cli.main(["--synthetic", "--iterations", "2", "--image-size", "32"]),
        lambda: dataset.load_emap(ModelConfig(source_path="unused")),
        lambda: make_ref_scale_scene(["--out", "unused"]),
        lambda: render_curves(["--edges", "unused"]),
        lambda: run_batch_abc.main(["--data-root", "unused"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert pcs.init_state(pts, n_views=1, device="cpu").curve_points.device.type == "cpu"


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def test_basis_wrapper_raises_without_its_kernel(monkeypatch):
    """On a CUDA tensor the K6b wrapper launches its kernel or raises: with
    no kernel library it raises, and neither falls back to the plain
    version nor counts a launch."""
    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load", no_library)
    H, W, *args = _small_blend_inputs("cpu")
    fields, gidx, counts, bg, gc, gtt = args
    col, finT = prc.blend_train_fwd(fields, gidx, counts, bg, H, W)
    n = prc.blend_train_bwd_basis.launches
    with pytest.raises(RuntimeError, match="cannot build tile_blend"):
        prc.blend_train_bwd_basis(fields.as_subclass(_ClaimsCuda), gidx, counts, col, finT, gc,
                                  gtt)
    assert prc.blend_train_bwd_basis.launches == n


def _small_blend_inputs(device):
    H, W, K = 40, 70, 16
    g = torch.Generator().manual_seed(0)
    P = 30
    mx = torch.rand(P, generator=g) * W
    my = torch.rand(P, generator=g) * H
    a = 0.02 + 0.1 * torch.rand(P, generator=g)
    c = 0.02 + 0.1 * torch.rand(P, generator=g)
    b = 0.5 * torch.sqrt(a * c) * (torch.rand(P, generator=g) - 0.5)
    opa = 0.2 + 0.8 * torch.rand(P, generator=g)
    z = torch.zeros(P)
    fields = torch.cat([torch.stack([mx, my, a, b, c, opa, z, z], -1), torch.zeros(2, 8)])
    nty, ntx = -(-H // 32), -(-W // 32)
    T = nty * ntx
    order = torch.argsort(torch.rand(P, generator=g))[:K]
    gidx = torch.full((T, K), P, dtype=torch.int32)
    gidx[:, : len(order)] = order.to(torch.int32)
    counts = torch.full((T,), len(order), dtype=torch.int32)
    gc = torch.randn(H, W, generator=g)
    gtt = torch.randn(H, W, generator=g)
    to = lambda t: t.to(device).contiguous()  # noqa: E731
    return H, W, to(fields), to(gidx), to(counts), to(torch.zeros(1)), to(gc), to(gtt)


def _channel_fields(fields, geo, invd, ones):
    """The training rows widened to a channel set: the six geometry fields,
    then seeded positive values in the colour, inverse-depth and allmap
    columns the set has."""
    _, nf = prc.field_layout(geo, invd, ones)
    n = (0 if ones else 1) + (1 if invd else 0) + (4 if geo else 0)
    g = torch.Generator().manual_seed(1)
    extra = 0.2 + torch.rand((fields.shape[0], n), generator=g).to(fields.device)
    pad = fields.new_zeros((fields.shape[0], nf - 6 - n))
    return torch.cat([fields[:, :6], extra, pad], dim=1).contiguous()


def _cotangents(H, W, device):
    g = torch.Generator().manual_seed(2)
    return tuple(torch.randn(s, generator=g).to(device).contiguous()
                 for s in ((H, W), (H, W), (H, W), (4, H, W)))


CHANNEL_SETS = [(True, True, True), (False, False, True), (True, True, False)]


def test_wrappers_launch_nothing_on_cpu():
    wrappers = (prc.blend_train_fwd, prc.blend_train_bwd, psc.ssim_fwd, psc.ssim_bwd,
                ptb.tile_blend_fwd, ptb.tile_blend_bwd, ptb.blend_moment_bwd,
                prc.blend_train_bwd_basis)
    before = [w.launches for w in wrappers]
    H, W, fields, gidx, counts, bg, gc, gtt = _small_blend_inputs("cpu")
    col, finT = prc.blend_train_fwd(fields, gidx, counts, bg, H, W)
    prc.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt)
    prc.blend_train_bwd_basis(fields, gidx, counts, col, finT, gc, gtt)
    psc.ssim_fwd(col, gc)
    psc.ssim_bwd(col, gc, torch.ones(()))
    for geo, invd, ones in CHANNEL_SETS:
        f = _channel_fields(fields, geo, invd, ones)
        outs = ptb.tile_blend_fwd(f, gidx, counts, bg, H, W, geo, invd, ones)
        ptb.tile_blend_bwd(f, gidx, counts, outs, _cotangents(H, W, "cpu"), geo, invd, ones)
    ptb.blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt)
    assert [w.launches for w in wrappers] == before == [0] * 8


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    H, W, fields, gidx, counts, bg, gc, gtt = _small_blend_inputs("cuda")
    n0 = prc.blend_train_fwd.launches
    col, finT = prc.blend_train_fwd(fields, gidx, counts, bg, H, W)
    col_p, finT_p = prc.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    assert prc.blend_train_fwd.launches == n0 + 1
    torch.testing.assert_close(col, col_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(finT, finT_p, atol=1e-6, rtol=0)
    # K3 at (F, F, T) computes K1's function with K1's first design: the
    # same operations on every pair that passes the gate, so bitwise
    col3, _, fin3, _ = ptb.tile_blend_fwd(fields, gidx, counts, bg, H, W, False, False, True)
    assert torch.equal(col, col3) and torch.equal(finT, fin3)
    acc = prc.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt)
    acc_p = prc.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    torch.testing.assert_close(acc, acc_p, atol=1e-4 * float(acc_p.abs().max()), rtol=0)
    v, v_p = psc.ssim_fwd(col, gc), psc.ssim_fwd_plain(col, gc)
    torch.testing.assert_close(v, v_p, atol=1e-5, rtol=0)
    g = torch.full((), 0.7, device="cuda")
    for d, d_p in zip(psc.ssim_bwd(col, gc, g), psc.ssim_bwd_plain(col, gc, g)):
        torch.testing.assert_close(d, d_p, atol=1e-4 * float(d_p.abs().max()), rtol=0)
    with pytest.raises(ValueError):
        prc.blend_train_fwd(fields.double(), gidx, counts, bg, H, W)  # kernels take float32
    # K3, K4 and K5: the same operations in the same order as the plain
    # versions (K3 bitwise), sums over a tile's pixels in another order
    for geo, invd, ones in CHANNEL_SETS:
        f = _channel_fields(fields, geo, invd, ones)
        n3, n4 = ptb.tile_blend_fwd.launches, ptb.tile_blend_bwd.launches
        outs = ptb.tile_blend_fwd(f, gidx, counts, bg, H, W, geo, invd, ones)
        outs_p = ptb.tile_blend_fwd_plain(f, gidx, counts, bg, H, W, geo, invd, ones)
        for o, o_p in zip(outs, outs_p):
            assert torch.equal(o, o_p), (geo, invd, ones, float((o - o_p).abs().max()))
        cots = _cotangents(H, W, "cuda")
        dpay = ptb.tile_blend_bwd(f, gidx, counts, outs, cots, geo, invd, ones)
        dpay_p = ptb.tile_blend_bwd_plain(f, gidx, counts, outs, cots, geo, invd, ones)
        torch.testing.assert_close(dpay, dpay_p, atol=1e-4 * float(dpay_p.abs().max()), rtol=0)
        assert (ptb.tile_blend_fwd.launches, ptb.tile_blend_bwd.launches) == (n3 + 1, n4 + 1)
    # K5: up to four quarter blocks add into a slot's row, so two runs
    # differ only in the order of the float32 sums
    n5 = ptb.blend_moment_bwd.launches
    mom = ptb.blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt)
    mom_again = ptb.blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt)
    assert ptb.blend_moment_bwd.launches == n5 + 2
    mom_p = ptb.blend_moment_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    torch.testing.assert_close(mom, mom_p, atol=1e-4 * float(mom_p.abs().max()), rtol=0)
    torch.testing.assert_close(mom_again, mom, atol=1e-6 * float(mom.abs().max()), rtol=0)
    # K6b: against its plain version, and (the same function) against K2
    n6 = prc.blend_train_bwd_basis.launches
    acc6 = prc.blend_train_bwd_basis(fields, gidx, counts, col, finT, gc, gtt)
    acc6_p = prc.blend_train_bwd_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    assert prc.blend_train_bwd_basis.launches == n6 + 1
    d6, d6_p, d2 = (prc.moments_to_dfields(a, fields) for a in (acc6, acc6_p, acc))
    torch.testing.assert_close(d6, d6_p, atol=1e-4 * float(d6_p.abs().max()), rtol=0)
    torch.testing.assert_close(d6, d2, atol=1e-3 * float(d2.abs().max()), rtol=0)


def _moments_within_mass(got, plain):
    """Each of the six moments of got [..., 8] within 1e-5 of its term mass
    in plain: M0, M3 and M5 sum positive terms here, and the terms of M1,
    M2 and M4 have at most the masses sqrt(M0 M3), sqrt(M0 M5) and
    sqrt(M3 M5) (Cauchy-Schwarz).  Returns the rows that are not."""
    m0, m3, m5 = plain[..., 0], plain[..., 3], plain[..., 5]
    mass = torch.stack([m0, (m0 * m3).sqrt(), (m0 * m5).sqrt(), m3, (m3 * m5).sqrt(), m5], -1)
    return int(((got - plain)[..., :6].abs() > 1e-5 * mass).any(dim=-1).sum())


def _cull_family_exact(family, device):
    """K1-K6b over one family of ``test_torch_port_cull_cases``, one
    instance per 2x2-tile block: K1 equal to its plain version and to K3 at
    (F, F, T) bitwise; K3 at (T, T, T) and (T, T, F) equal to its plain
    version and K4 there within 1e-4 of max of its plain version (the
    family's rows widened by ``_channel_fields``); K2's moments and K5's
    per-slot rows within 1e-5 of each term mass from their plain versions
    (``_moments_within_mass``: with bg 0, gtt 0 and one instance per tile,
    D' = gc G with gc in [1, 2) at every contributing pixel); K6b's field
    gradients within 1e-4 of max of its plain version's and 1e-3 of K2's
    (its recombination cancels terms up to ~31^2 times its result)."""
    H, W, fields, gidx, counts = packed_family(family, device)
    bg = torch.zeros(1, device=device)
    col, finT = prc.blend_train_fwd(fields, gidx, counts, bg, H, W)
    col_p, finT_p = prc.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    col3, _, fin3, _ = ptb.tile_blend_fwd(fields, gidx, counts, bg, H, W, False, False, True)
    assert torch.equal(col, col_p) and torch.equal(finT, finT_p), family
    assert torch.equal(col, col3) and torch.equal(finT, fin3), family
    cots = _cotangents(H, W, device)
    for geo, invd, ones in ((True, True, True), (True, True, False)):
        f = _channel_fields(fields, geo, invd, ones)
        outs = ptb.tile_blend_fwd(f, gidx, counts, bg, H, W, geo, invd, ones)
        outs_p = ptb.tile_blend_fwd_plain(f, gidx, counts, bg, H, W, geo, invd, ones)
        assert all(torch.equal(o, o_p) for o, o_p in zip(outs, outs_p)), (family, geo, invd, ones)
        dpay = ptb.tile_blend_bwd(f, gidx, counts, outs, cots, geo, invd, ones)
        dpay_p = ptb.tile_blend_bwd_plain(f, gidx, counts, outs, cots, geo, invd, ones)
        torch.testing.assert_close(dpay, dpay_p, atol=1e-4 * float(dpay_p.abs().max()), rtol=0,
                                   msg=f"{family} {(geo, invd, ones)}")
    g = torch.Generator().manual_seed(3)
    gc = (1.0 + torch.rand((H, W), generator=g)).to(device)
    gtt = torch.zeros_like(gc)
    acc = prc.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt)
    acc_p = prc.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    assert _moments_within_mass(acc, acc_p) == 0, family
    mom = ptb.blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt)
    mom_p = ptb.blend_moment_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    assert _moments_within_mass(mom, mom_p) == 0, family
    acc6 = prc.blend_train_bwd_basis(fields, gidx, counts, col, finT, gc, gtt)
    acc6_p = prc.blend_train_bwd_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    d6, d6_p, d2 = (prc.moments_to_dfields(a, fields) for a in (acc6, acc6_p, acc))
    torch.testing.assert_close(d6, d6_p, atol=1e-4 * float(d6_p.abs().max()), rtol=0,
                               msg=f"{family} K6b")
    torch.testing.assert_close(d6, d2, atol=1e-3 * float(d2.abs().max()), rtol=0,
                               msg=f"{family} K6b against K2")
    return int((acc_p[:, 0] > 0).sum())  # the instances that contribute


@pytest.mark.cuda
def test_cull_exact_on_adversarial_conics():
    """The kernels' own box (device ``logf``/``sqrtf``) never skips a pair
    that passes the gate, in K1-K6b, over the families whose float32 mirror
    ``test_torch_port_cull.py`` checks on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    wrappers = (prc.blend_train_fwd, ptb.tile_blend_bwd, ptb.blend_moment_bwd,
                prc.blend_train_bwd_basis)
    before = [w.launches for w in wrappers]
    for family in FAMILIES:
        assert _cull_family_exact(family, "cuda") > 0, family  # some instance contributes
    n = len(FAMILIES)
    assert [w.launches for w in wrappers] == [b + k * n for b, k in zip(before, (1, 2, 1, 1))]


# ragged against K7/K8's 32x32 tiles, and some below the 11-tap window
SSIM_SHAPES = [(512, 512), (37, 300), (300, 37), (17, 300), (5, 7), (1, 33)]


@pytest.mark.cuda
def test_ssim_kernels_at_ragged_shapes_on_card():
    """K8 equal to its plain version at every shape (the same per-pixel sums
    in the same order); K7 within 1e-5 of its plain version (only its
    partial sums run in another order), 1 within 1e-6 on identical images,
    equal from call to call (the last block adds the partials in a fixed
    order) and right at every size right after another (the ticket
    resets), in one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    rng = np.random.default_rng(5)
    g = torch.full((), -0.3, device="cuda")
    values, plains = [], []
    for H, W in SSIM_SHAPES:
        a = torch.tensor(rng.uniform(size=(H, W)), dtype=torch.float32, device="cuda")
        b = torch.tensor(0.5 * rng.uniform(size=(H, W)) ** 3, dtype=torch.float32, device="cuda")
        b = (0.5 * a + b).contiguous()  # correlated with a
        n7, n8 = psc.ssim_fwd.launches, psc.ssim_bwd.launches
        v = psc.ssim_fwd(a, b)
        same = psc.ssim_fwd(a, a)
        again = psc.ssim_fwd(a, b)
        d = psc.ssim_bwd(a, b, g)
        assert (psc.ssim_fwd.launches, psc.ssim_bwd.launches) == (n7 + 3, n8 + 1)
        values.append(v)
        plains.append(psc.ssim_fwd_plain(a, b))
        assert torch.equal(v, again), (H, W)
        assert abs(float(same) - 1.0) <= 1e-6, (H, W, float(same))
        for k, k_p in zip(d, psc.ssim_bwd_plain(a, b, g)):
            assert torch.equal(k, k_p), (H, W, float((k - k_p).abs().max()))
    for (H, W), v, v_p in zip(SSIM_SHAPES, values, plains):
        assert abs(float(v) - float(v_p)) <= 1e-5, (H, W, float(v), float(v_p))
