"""The port stands alone: no module of ``curve_gaussian_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, entry points run on the
card unless the caller asks for the CPU, and the kernel wrappers launch
nothing for CPU tensors.  The last test needs a CUDA card and holds every
kernel against its plain version there
(``pytest --noconftest -m cuda tests/test_torch_port_isolation.py``)."""
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
from curve_gaussian_tpu_torch.data import synthetic
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.ops import camera as pcam
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops import ssim_cuda as psc
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as ptb

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "curve_gaussian_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "curve_gaussian_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="curve_gaussian_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert len(mods) >= 35 and "curve_gaussian_tpu_torch.ops.tile_blend_cuda" in mods, mods
    for m in ("engine.loop", "engine.checkpoint", "models.surgery", "models.fitting",
              "eval.extract", "eval.metrics", "data.ply", "models.ellipsoids",
              "models.gaussian_ply", "train"):
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
    # versions, sums over a tile's pixels in another order
    for geo, invd, ones in CHANNEL_SETS:
        f = _channel_fields(fields, geo, invd, ones)
        n3, n4 = ptb.tile_blend_fwd.launches, ptb.tile_blend_bwd.launches
        outs = ptb.tile_blend_fwd(f, gidx, counts, bg, H, W, geo, invd, ones)
        outs_p = ptb.tile_blend_fwd_plain(f, gidx, counts, bg, H, W, geo, invd, ones)
        for o, o_p in zip(outs, outs_p):
            torch.testing.assert_close(o, o_p, atol=1e-6, rtol=0)
        cots = _cotangents(H, W, "cuda")
        dpay = ptb.tile_blend_bwd(f, gidx, counts, outs, cots, geo, invd, ones)
        dpay_p = ptb.tile_blend_bwd_plain(f, gidx, counts, outs, cots, geo, invd, ones)
        torch.testing.assert_close(dpay, dpay_p, atol=1e-4 * float(dpay_p.abs().max()), rtol=0)
        assert (ptb.tile_blend_fwd.launches, ptb.tile_blend_bwd.launches) == (n3 + 1, n4 + 1)
    mom = ptb.blend_moment_bwd(fields, gidx, counts, col, finT, gc, gtt)
    mom_p = ptb.blend_moment_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    torch.testing.assert_close(mom, mom_p, atol=1e-4 * float(mom_p.abs().max()), rtol=0)
    # K6b: against its plain version, and (the same function) against K2
    n6 = prc.blend_train_bwd_basis.launches
    acc6 = prc.blend_train_bwd_basis(fields, gidx, counts, col, finT, gc, gtt)
    acc6_p = prc.blend_train_bwd_basis_plain(fields, gidx, counts, col, finT, gc, gtt)
    assert prc.blend_train_bwd_basis.launches == n6 + 1
    d6, d6_p, d2 = (prc.moments_to_dfields(a, fields) for a in (acc6, acc6_p, acc))
    torch.testing.assert_close(d6, d6_p, atol=1e-4 * float(d6_p.abs().max()), rtol=0)
    torch.testing.assert_close(d6, d2, atol=1e-3 * float(d2.abs().max()), rtol=0)
