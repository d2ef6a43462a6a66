"""The plain reference against the program's CPU path (its plain PyTorch
versions of every kernel) on a tiny scene: the tile lists equal, and
three training steps through the program's chunk within rounding of the
reference's, in float64 and in float32."""
from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import REPO

from curve_gaussian_tpu_torch.ops import binning as PB
from curve_gaussian_tpu_torch.ops import projection as PP
from curve_gaussian_tpu_torch.ops.camera import Camera
from curve_gaussian_tpu_torch.ops.ssim import ssim as port_ssim
from curve_gaussian_tpu_torch.models import curve_state as cs


def tiny(kind: str, dtype, seed: int = 7):
    from benchmark import scene as SC

    cfg = json.loads((REPO / "benchmark/configs/abc_nef_800.json").read_text())
    cfg["scene"].update(views=5, height=64, width=96, curves=3, lines=1, samples=64)
    traffic = json.loads((REPO / f"benchmark/traffic/{kind}.json").read_text())
    traffic["population"].update(grid=4, capacity=256)
    traffic["population"]["alive"] = 20
    traffic["pipeline"]["tile_capacity"] = 512
    dev = torch.device("cpu")
    cfg["scene"]["seed"] = seed
    sc = SC.make_scene(cfg, dev)
    pop = SC.population(cfg, traffic, sc, seed, dev)
    if dtype != torch.float32:
        cams = sc.cams._replace(w2c=sc.cams.w2c.to(dtype), proj=sc.cams.proj.to(dtype),
                                centers=sc.cams.centers.to(dtype))
        sc = sc._replace(cams=cams, gts=sc.gts.to(dtype))
        pop = pop._replace(**{k: v.to(dtype) for k, v in pop._asdict().items()
                              if v.is_floating_point()})
    return cfg, traffic, sc, pop


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_tile_lists_equal(kind):
    from benchmark import reference as R

    cfg, traffic, sc, pop = tiny(kind, torch.float32)
    c = sc.cams
    with torch.no_grad():
        g = R.gaussians({k: getattr(pop, k) for k in R.LIVE}, pop.is_bezier, pop.alive, 12)
        state = cs.CurveState(**pop._asdict())
        pg = cs.gaussians(state)
        for v in range(c.w2c.shape[0]):
            pre = R.project(g, c.w2c[v], c.proj[v], c.height, c.width, c.tanfovx, c.tanfovy)
            cam = Camera(c.w2c[v], c.proj[v], c.centers[v], c.height, c.width, c.tanfovx,
                         c.tanfovy)
            ppre = PP.preprocess(pg["xyz"], pg["scale"], pg["quat"], pg["opacity"], cam,
                                 alive=pg["alive"])
            torch.testing.assert_close(pre.mean2d, ppre.mean2d, rtol=0, atol=0)
            torch.testing.assert_close(pre.conic, ppre.conic, rtol=0, atol=0)
            gidx, counts, overflow, peak, *_ = R.bin_tiles(pre, c.height, c.width, 512, 256)
            pb = PB.bin_gaussians(ppre, c.height, c.width, capacity=512, big_capacity=256)
            assert torch.equal(gidx, pb.gather_idx) and torch.equal(counts, pb.counts)
            assert (overflow, peak) == (int(pb.overflow), int(pb.peak))
            assert int(counts.sum()) > 0


def test_ssim_matches():
    from benchmark import reference as R

    g = torch.Generator().manual_seed(3)
    a, b = torch.rand((40, 70), generator=g), torch.rand((40, 70), generator=g)
    assert abs(float(R.ssim(a, b)) - float(port_ssim(a, b))) < 1e-6


@pytest.mark.parametrize("kind,dtype,tol", [
    ("dense", torch.float64, 1e-9), ("sparse", torch.float64, 1e-9),
    ("dense", torch.float32, 1e-5), ("sparse", torch.float32, 1e-5)])
def test_three_steps_match(kind, dtype, tol):
    from benchmark import compare
    from benchmark.program import Program

    cfg, traffic, sc, pop = tiny(kind, dtype)
    prog = Program(cfg, traffic, sc)
    ts0 = prog.init_state(pop)
    rows = [[0], [3], [1]]
    s1, m1 = prog.chunk(ts0, rows[:1])
    s3, m23 = prog.chunk(s1, rows[1:])
    first = dict(losses=torch.cat([m1["total"], m23["total"]]).tolist(),
                 mu1=prog.first_moments(s1), p3=prog.params(s3),
                 p0={k: getattr(pop, k) for k in cs.TRAINABLE_FIELDS})
    ref = compare.reference_side(cfg, traffic, sc, pop, rows, dtype=dtype)
    got = compare.gaps(compare.program_side(first), ref)
    assert max(got.values()) < tol, got
    assert float(ref["change"]["curve_points"].abs().max()) > 0  # the steps moved the curves
