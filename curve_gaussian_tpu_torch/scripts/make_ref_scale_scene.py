"""Fabricate a reference-scale EMAP dataset (ABC-like geometry) on disk with
the port, as the repository's ``scripts/make_ref_scale_scene.py`` does with
the JAX package.

Random Bézier and line primitives in the unit cube are splatted by the
port's render (the training channel set: K1 on the card) at full
resolution from a ring of cameras and written as the "detector" edge maps
under ``edge_<detector>/`` (a copy under ``color/``), with
``meta_data.json`` (per-view camtoworld and intrinsics) and the
ground-truth primitives in ``gt_edges.json``.  The defaults are the
reference's operating point: 1600² images, 50 views, 24 Béziers and 8
lines, trained at ``-r 2`` (800²).  The optional pathologies (dropout
gaps, a ghost double edge, salt noise, a separable blur with its re-peak)
draw from the JAX script's random streams, so one seed gives both the same
scene up to float32 render noise.

    python -m curve_gaussian_tpu_torch.scripts.make_ref_scale_scene --out output_torch/refscale
    python -m curve_gaussian_tpu_torch.train -s output_torch/refscale -r 2
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import synthetic
from ..data.png import write_png
from ..ops import bezier
from ..ops.camera import fov2focal
from ..ops.render import render


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fabricate a reference-scale EMAP scene")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=1600)
    p.add_argument("--height", type=int, default=None,
                   help="non-square images (e.g. 680 with --size 1200 for the Replica "
                        "protocol); default = --size")
    p.add_argument("--views", type=int, default=50)
    p.add_argument("--curves", type=int, default=24)
    p.add_argument("--lines", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--detector", default="DexiNed",
                   help="edge-map directory suffix (edge_<detector>/)")
    p.add_argument("--edge-blur", type=float, default=0.0,
                   help="Gaussian sigma (px) smearing the maps (PidiNet-like soft edges)")
    p.add_argument("--gt-width", type=float, default=0.003)
    p.add_argument("--dropout-frac", type=float, default=0.0,
                   help="fraction of lit edge pixels erased in disk-shaped gaps per view")
    p.add_argument("--dropout-radius", type=int, default=6, help="gap radius in px")
    p.add_argument("--double-edge", type=float, default=0.0,
                   help="gain of a ghost copy of the edge map shifted a few px")
    p.add_argument("--double-shift", type=int, default=4, help="ghost shift in px")
    p.add_argument("--salt", type=float, default=0.0,
                   help="fraction of pixels firing as isolated salt noise")
    p.add_argument("--tile-capacity", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def corrupt(img: np.ndarray, vr: np.random.Generator, args) -> np.ndarray:
    """The detector pathologies the options ask for, in the JAX script's
    order and from its per-view stream `vr`."""
    if args.dropout_frac > 0:
        lit = np.argwhere(img > 0.05)
        if len(lit):
            # expected erased px per gap ~ pi r^2 / 2: the gap count makes the
            # erased share of lit pixels about --dropout-frac
            r = args.dropout_radius
            n_gaps = max(1, int(args.dropout_frac * len(lit) / (np.pi * r * r * 0.5)))
            centers = lit[vr.integers(0, len(lit), n_gaps)]
            pad = np.pad(img, r)
            yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
            keep = ((yy**2 + xx**2) > r * r).astype(img.dtype)
            for cy, cx in centers:  # in-image centres: the padded slices are whole
                pad[cy: cy + 2 * r + 1, cx: cx + 2 * r + 1] *= keep
            img = pad[r:-r, r:-r]
    if args.double_edge > 0:
        sh = args.double_shift
        dy, dx = (int(v) for v in vr.integers(-sh, sh + 1, 2))
        ghost = np.roll(img, (dy, dx), (0, 1))
        # zero the wrapped strips so that the ghost invents no edge on the far border
        if dy > 0:
            ghost[:dy] = 0
        if dy < 0:
            ghost[dy:] = 0
        if dx > 0:
            ghost[:, :dx] = 0
        if dx < 0:
            ghost[:, dx:] = 0
        img = np.maximum(img, args.double_edge * ghost)
    if args.salt > 0:
        mask = vr.uniform(size=img.shape) < args.salt
        img = np.maximum(img, mask * vr.uniform(0.5, 1.0, img.shape))
    if args.edge_blur > 0:
        r = max(1, int(3 * args.edge_blur))
        x = np.arange(-r, r + 1)
        k = np.exp(-(x**2) / (2 * args.edge_blur**2))
        k /= k.sum()
        img = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, img)
        img = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, img)
        img /= max(img.max(), 1e-6)  # re-peak to 1 like detector output
    return img


def scene_splats(args, device):
    """The scene's ground-truth curves (control points [N, 4, 3], is_bezier
    [N]) and their splats (xyz, scale, quat, opacity: 64 Gaussians a
    curve at width --gt-width, opacity 0.95)."""
    cp, is_bez = synthetic.random_curves(np.random.default_rng(args.seed), args.curves,
                                         args.lines)
    g = bezier.curve_gaussians(
        torch.as_tensor(cp, device=device),
        torch.full((cp.shape[0],), args.gt_width, dtype=torch.float32, device=device),
        torch.as_tensor(is_bez, device=device), 64)
    xyz = g["xyz"].reshape(-1, 3)
    opa = torch.full((xyz.shape[0],), 0.95, dtype=torch.float32, device=device)
    return cp, is_bez, (xyz, g["scale"].reshape(-1, 3), g["quat"].reshape(-1, 4), opa)


def make_ref_scale_scene(argv=None, quiet: bool = False) -> dict:
    """Write the scene that ``argv`` (the CLI's arguments) describes.
    Returns the per-view overflow counts, the host seconds spent rendering
    (the render and its copy to the host) and writing (the pathologies, the
    PNGs and the JSON files), and view 0's uint8 edge map as written."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cp, is_bez, (xyz, scale, quat, opa) = scene_splats(args, dev)
    W = args.size
    H = args.height or args.size
    cams = synthetic.ring_cameras(args.views, H, W, device=dev)

    edge_dir = f"edge_{args.detector}"
    os.makedirs(os.path.join(args.out, "color"), exist_ok=True)
    os.makedirs(os.path.join(args.out, edge_dir), exist_ok=True)
    frames, overflow, first = [], [], None
    seconds = dict(render=0.0, write=0.0)
    for i, cam in enumerate(cams):
        t0 = time.time()
        with torch.no_grad():
            out = render(xyz, scale, quat, opa, cam, bg=0.0, capacity=args.tile_capacity,
                         render_geo=False, compute_invdepth=False)
        img = out["render"].cpu().numpy()
        overflow.append(int(out["overflow"]))
        t1 = time.time()
        seconds["render"] += t1 - t0
        if overflow[-1]:
            print(f"view {i}: overflow {overflow[-1]} (raise --tile-capacity)", flush=True)
        img = corrupt(img, np.random.default_rng(args.seed * 1000 + 7919 + i), args)
        name = f"{i:04d}.png"
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        first = arr if first is None else first
        write_png(os.path.join(args.out, edge_dir, name), arr)
        # color/ is consulted only for its path name: the same map keeps the
        # layout of a real EMAP export
        write_png(os.path.join(args.out, "color", name), arr)
        w2c = cam.world_to_cam.cpu().double().numpy()
        K = np.array([
            [fov2focal(2 * np.arctan(cam.tanfovx), W), 0.0, W / 2],
            [0.0, fov2focal(2 * np.arctan(cam.tanfovy), H), H / 2],
            [0.0, 0.0, 1.0],
        ])
        frames.append({"rgb_path": name, "camtoworld": np.linalg.inv(w2c).tolist(),
                       "intrinsics": K.tolist()})
        seconds["write"] += time.time() - t1
        if not quiet:
            print(f"view {i}: mean {img.mean():.4f} max {img.max():.3f}", flush=True)

    t0 = time.time()
    with open(os.path.join(args.out, "meta_data.json"), "w") as f:
        json.dump({"height": H, "width": W, "frames": frames}, f)
    gt = {  # the ground-truth primitives, for the evaluation after training
        "curves_ctl_pts": cp[is_bez].reshape(-1, 12).tolist(),
        "lines_end_pts": cp[~is_bez][:, [0, 3], :].reshape(-1, 6).tolist(),
    }
    with open(os.path.join(args.out, "gt_edges.json"), "w") as f:
        json.dump(gt, f)
    seconds["write"] += time.time() - t0
    print(f"wrote {args.views} views @ {W}x{H} -> {args.out}", flush=True)
    return dict(overflow=overflow, seconds=seconds, first_view=first)


if __name__ == "__main__":
    make_ref_scale_scene()
