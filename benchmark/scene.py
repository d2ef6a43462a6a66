"""The benchmark's inputs, made on the device by the benchmark's own plain
code from the configuration and ``--seed``: the cameras, the ground-truth
primitives, their edge maps and the initial curve population.  Nothing
here imports the program, so the reference and the program read the same
tensors and neither made them.

- **Cameras**: a ring of ``views`` look-at cameras around (0.5, 0.5, 0.5)
  at radius 2.2, elevations cycling -0.35, 0, 0.45, ``fovx`` degrees
  across (the scene maker's rig).  Matrices act on column vectors:
  ``w2c`` [V,4,4], ``proj`` = perspective @ w2c (znear 0.01, zfar 100),
  ``centers`` [V,3]; built in float64, stored in float32.
- **Primitives**: ``curves`` smooth cubic Beziers and ``lines`` segments in
  the unit cube, drawn on the device from one generator seeded by the
  configuration's scene ``seed``: every run trains the same scene, so the
  work is the same from run seed to run seed.
- **Edge maps** [V,H,W]: every primitive sampled at ``samples`` points,
  each point projected and splatted as a Gaussian footprint of sigma half
  the projected GT width (at least ``min_sigma_px``), max-composited (a
  thin, DexiNed-like line of peak 1); with ``blur_px`` > 0 the map is
  blurred separably and re-peaked to 1 (a PidiNet-like soft edge).
- **Population**: ``dense``, the reference's grid seed (``grid``^3 points
  over [-0.05, 1.05]^3, one Y-aligned Bezier each); ``sparse``, the
  primitives with jitter on their control points plus grid seeds drawn
  without replacement, up to ``alive`` curves, in a capacity of
  ``capacity``, both from the run's seed.  Widths 5e-3, opacities 0.6,
  mask logits 1.0, as the program's ``init_state``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0
RING_RADIUS = 2.2
RING_CENTER = (0.5, 0.5, 0.5)
RING_ELEVATIONS = (-0.35, 0.0, 0.45)
INIT_OPACITY = 0.6
INIT_WIDTH = 5e-3
INIT_MASK = 1.0
INIT_HALF_LEN = 0.5  # of sqrt(mean squared distance to the 3 nearest seeds)


class Cameras(NamedTuple):
    w2c: torch.Tensor  # [V, 4, 4]
    proj: torch.Tensor  # [V, 4, 4]
    centers: torch.Tensor  # [V, 3]
    height: int
    width: int
    tanfovx: float
    tanfovy: float


class Scene(NamedTuple):
    cams: Cameras
    gts: torch.Tensor  # [V, H, W] float32 edge maps in [0, 1]
    curves: torch.Tensor  # [N, 4, 3] ground-truth control points
    is_bezier: torch.Tensor  # [N] bool


class Population(NamedTuple):
    """The initial curve population, padded to its capacity."""
    curve_points: torch.Tensor  # [C, 4, 3]
    opacity_raw: torch.Tensor  # [C]
    width_raw: torch.Tensor  # [C]
    mask_raw: torch.Tensor  # [C, M]
    features_dc: torch.Tensor  # [C, M, 1]
    exposure: torch.Tensor  # [V, 2]
    is_bezier: torch.Tensor  # [C] bool
    alive: torch.Tensor  # [C] bool


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded by `seed` (any non-negative int below
    2**64), so the same seed gives the same inputs."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def ring_cameras(views: int, height: int, width: int, fovx_deg: float, device) -> Cameras:
    fovx = math.radians(fovx_deg)
    tx = math.tan(fovx / 2.0)
    focal = width / (2.0 * tx)
    ty = height / (2.0 * focal)
    persp = np.zeros((4, 4))
    persp[0, 0], persp[1, 1] = 1.0 / tx, 1.0 / ty
    persp[2, 2] = ZFAR / (ZFAR - ZNEAR)
    persp[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    persp[3, 2] = 1.0
    center = np.asarray(RING_CENTER)
    w2cs, projs, eyes = [], [], []
    for i in range(views):
        theta = 2.0 * math.pi * i / views
        elev = RING_ELEVATIONS[i % len(RING_ELEVATIONS)]
        eye = center + RING_RADIUS * np.array([math.cos(theta) * math.cos(elev), math.sin(elev),
                                               math.sin(theta) * math.cos(elev)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd])  # world -> camera rows: x right, y down, z forward
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = rot, -rot @ eye
        w2cs.append(w2c)
        projs.append(persp @ w2c)
        eyes.append(np.linalg.inv(w2c)[:3, 3])
    as_t = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=device)  # noqa: E731
    return Cameras(as_t(w2cs), as_t(projs), as_t(eyes), int(height), int(width), tx, ty)


def random_primitives(gen: torch.Generator, curves: int, lines: int, device):
    """(control points [N,4,3], is_bezier [N]): smooth random Beziers and
    straight segments in the unit cube (a line's rows 1 and 2 repeat its
    end points)."""
    n = curves + lines
    kw = dict(generator=gen, device=device)
    p0 = 0.15 + 0.7 * torch.rand((n, 3), **kw)
    d = torch.randn((n, 3), **kw)
    d = d / d.norm(dim=-1, keepdim=True)
    length = 0.2 + 0.25 * torch.rand((n, 1), **kw)
    p3 = (p0 + d * length).clamp(0.02, 0.98)
    bend = 0.06 * torch.randn((2, n, 3), **kw)
    p1 = p0 + (p3 - p0) / 3 + bend[0]
    p2 = p0 + 2 * (p3 - p0) / 3 + bend[1]
    cp = torch.stack([p0, p1, p2, p3], dim=1)
    is_bez = torch.arange(n, device=device) < curves
    cp[curves:, 1], cp[curves:, 2] = cp[curves:, 0], cp[curves:, 3]
    return cp, is_bez


def curve_samples(cp: torch.Tensor, is_bez: torch.Tensor, samples: int) -> torch.Tensor:
    """[N * samples, 3] points on each primitive at evenly spaced t."""
    t = torch.linspace(0.0, 1.0, samples, device=cp.device)[None, :, None]
    p0, p1, p2, p3 = (cp[:, i, None, :] for i in range(4))
    u = 1.0 - t
    bez = u ** 3 * p0 + 3 * u ** 2 * t * p1 + 3 * u * t ** 2 * p2 + t ** 3 * p3
    lin = u * p0 + t * p3
    return torch.where(is_bez[:, None, None], bez, lin).reshape(-1, 3)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [V, H, W] with zero padding."""
    r = max(1, int(3 * sigma))
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = k / k.sum()
    out = torch.nn.functional.conv2d(img[:, None], k.view(1, 1, 1, -1), padding=(0, r))
    return torch.nn.functional.conv2d(out, k.view(1, 1, -1, 1), padding=(r, 0))[:, 0]


def edge_maps(cams: Cameras, cp: torch.Tensor, is_bez: torch.Tensor, width: float,
              samples: int, min_sigma_px: float, blur_px: float,
              views_per_call: int = 10) -> torch.Tensor:
    """[V, H, W] edge maps of the primitives (see the module docstring),
    drawn in a few large calls of ``views_per_call`` views."""
    H, W = cams.height, cams.width
    pts = curve_samples(cp, is_bez, samples)
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)  # [S, 4]
    fx = W / (2.0 * cams.tanfovx)
    r = 3
    off = torch.arange(-r, r + 1, device=pts.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    out = []
    for v0 in range(0, cams.w2c.shape[0], views_per_call):
        w2c = cams.w2c[v0:v0 + views_per_call].double()
        proj = cams.proj[v0:v0 + views_per_call].double()
        cam = torch.einsum("vij,sj->vsi", w2c, hom.double())
        clip = torch.einsum("vij,sj->vsi", proj, hom.double())
        ndc = clip[..., :2] / clip[..., 3:4]
        # the program's pixel convention: ((ndc + 1) size - 1) / 2, pixel i at i
        x = ((ndc[..., 0] + 1.0) * W - 1.0) * 0.5
        y = ((ndc[..., 1] + 1.0) * H - 1.0) * 0.5
        sigma = torch.clamp(0.5 * width * fx / cam[..., 2], min=min_sigma_px)
        ix = torch.round(x).long()[..., None] + ox
        iy = torch.round(y).long()[..., None] + oy
        d2 = (ix - x[..., None]) ** 2 + (iy - y[..., None]) ** 2
        val = torch.exp(-d2 / (2.0 * sigma[..., None] ** 2)).float()
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (cam[..., 2:3] > 0.2)
        nv = w2c.shape[0]
        flat = torch.zeros((nv, H * W), dtype=torch.float32, device=pts.device)
        vix = torch.arange(nv, device=pts.device)[:, None, None].expand_as(ix)
        idx = (vix * (H * W) + iy * W + ix)[ok]
        flat.view(-1).scatter_reduce_(0, idx, val[ok], reduce="amax")
        out.append(flat.view(nv, H, W))
    img = torch.cat(out)
    if blur_px > 0:
        img = _blur(img, blur_px)
        img = img / img.amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    return img.clamp(0.0, 1.0).contiguous()


def make_scene(config: dict, device) -> Scene:
    """The cameras, primitives and edge maps of a configuration file's
    ``scene`` entry: one scene a configuration (its primitives drawn from
    the entry's ``seed``), as a benchmark's scan is fixed; a run's seed
    draws its view order and its population."""
    s = config["scene"]
    gen = generator(s["seed"], device)
    cams = ring_cameras(s["views"], s["height"], s["width"], s["fovx_deg"], device)
    cp, is_bez = random_primitives(gen, s["curves"], s["lines"], device)
    gts = edge_maps(cams, cp, is_bez, s["gt_width"], s["samples"], s["min_sigma_px"],
                    s["blur_px"])
    return Scene(cams, gts, cp, is_bez)


def grid_points(n: int, device) -> torch.Tensor:
    """The reference's grid seed: n^3 points over [-0.05, 1.05]^3, in the
    order of numpy's meshgrid (x varies along axis 1)."""
    x = torch.linspace(-0.05, 1.05, n, dtype=torch.float64, device=device)
    xx, yy, zz = torch.meshgrid(x, x, x, indexing="xy")
    return torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], 1).float()


def seed_curves(points: torch.Tensor, among: torch.Tensor) -> torch.Tensor:
    """One Y-aligned Bezier per seed point, control points at centre
    -/+ {1, 0.5} bound along +Y, bound = 0.5 sqrt(mean squared distance to
    the 3 nearest points of `among`, the point itself left out)."""
    d2 = torch.cdist(points.double(), among.double()) ** 2
    d2 = torch.where(d2 == 0, torch.full_like(d2, torch.inf), d2)
    near = torch.topk(d2, 3, dim=1, largest=False).values.mean(dim=1)
    bound = (INIT_HALF_LEN * torch.sqrt(near.clamp(min=1e-7))).float()
    step = torch.stack([torch.zeros_like(bound), bound, torch.zeros_like(bound)], dim=-1)
    return torch.stack([points - step, points - 0.5 * step, points + 0.5 * step, points + step],
                       dim=1)


def population(config: dict, traffic: dict, scene: Scene, seed: int, device) -> Population:
    """The initial population of the traffic mix's phase (module docstring)."""
    pop = traffic["population"]
    M = config["model"]["n_gaussians"]
    grid = grid_points(pop["grid"], device)
    if pop["kind"] == "dense":
        cp = seed_curves(grid, grid)
        is_bez = torch.ones(cp.shape[0], dtype=torch.bool, device=device)
    elif pop["kind"] == "sparse":
        gen = generator(seed, device)
        prim = scene.curves + pop["gt_jitter"] * torch.randn(
            scene.curves.shape, generator=gen, device=device)
        line = ~scene.is_bezier
        prim[line, 1], prim[line, 2] = prim[line, 0], prim[line, 3]
        n_grid = pop["alive"] - prim.shape[0]
        pick = torch.randperm(grid.shape[0], generator=gen, device=device)[:n_grid]
        cp = torch.cat([prim, seed_curves(grid[pick], grid)])
        is_bez = torch.cat([scene.is_bezier,
                            torch.ones(n_grid, dtype=torch.bool, device=device)])
    else:
        raise ValueError(f"population kind {pop['kind']!r} is not 'dense' or 'sparse'")
    n, cap = cp.shape[0], pop["capacity"]
    if n > cap:
        raise ValueError(f"{n} curves do not fit a capacity of {cap}")

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=device)
        out[:n] = x
        return out

    ones = torch.ones(n, dtype=torch.float32, device=device)
    return Population(
        curve_points=pad(cp),
        opacity_raw=pad(ones * math.log(INIT_OPACITY / (1.0 - INIT_OPACITY))),
        width_raw=pad(ones * float(np.log(INIT_WIDTH))),
        mask_raw=pad(torch.full((n, M), INIT_MASK, device=device)),
        features_dc=pad(torch.zeros((n, M, 1), device=device)),
        exposure=torch.tensor([1.0, 0.0], device=device).repeat(scene.gts.shape[0], 1),
        is_bezier=pad(is_bez, False),
        alive=pad(torch.ones(n, dtype=torch.bool, device=device), False),
    )
