"""Render fitted parametric curves along a camera path (a novel-view video),
as the repository's ``scripts/render_curves.py`` does with the JAX package.

Reads ``parametric_edges.json`` (lines become cubic control points), samples
each edge into 32 Gaussians of the given width at opacity 0.95
(``bezier.curve_gaussians``) and splats every view with the port's render at
its default channel set (K3 on the card, one launch per frame).  The
cameras are an orbit (``ring_cameras``) or a NeRF-style
``transforms_video.json``.  Frames land in <out>/frames/ and are stitched
to <out>/curves.mp4 when ffmpeg is installed.

    python -m curve_gaussian_tpu_torch.scripts.render_curves --edges <run>/parametric_edges.json
    python -m curve_gaussian_tpu_torch.scripts.render_curves --edges ... --device cpu --size 64
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.png import write_png
from ..data.synthetic import ring_cameras
from ..eval.replica import stitch_video
from ..ops import bezier
from ..ops.camera import make_camera
from ..ops.render import render

M_PER = 32  # Gaussians per edge
OPACITY = 0.95
CAPACITY = 1024  # tile capacity of each frame's render


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="render parametric curves along a camera path")
    p.add_argument("--edges", required=True, help="parametric_edges.json")
    p.add_argument("--transforms", default=None,
                   help="transforms_video.json (NeRF-style); default: an orbit")
    p.add_argument("--out", default="curve_video")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n-orbit", type=int, default=60)
    p.add_argument("--width", type=float, default=0.003)
    p.add_argument("--n-devices", type=int, default=None,
                   help="tile-parallel rendering over N devices (multi-device slice; raises)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def edge_gaussians(edge_dict: dict, width: float, device):
    """(xyz, scale, quat, opacity) of the edges' Gaussians on `device`: the
    Béziers, then the lines with their endpoints in control rows 0 and 3."""
    curves = np.array(edge_dict.get("curves_ctl_pts", []), np.float32).reshape(-1, 4, 3)
    lines = np.array(edge_dict.get("lines_end_pts", []), np.float32).reshape(-1, 2, 3)
    line_cp = np.zeros((len(lines), 4, 3), np.float32)
    line_cp[:, 0] = lines[:, 0]
    line_cp[:, 3] = lines[:, 1]
    cp = np.concatenate([curves, line_cp])
    is_bez = np.arange(len(cp)) < len(curves)
    if len(cp) == 0:
        raise ValueError("no edges in the json")
    g = bezier.curve_gaussians(
        torch.as_tensor(cp, device=device), torch.full((len(cp),), width, device=device),
        torch.as_tensor(is_bez, device=device), M_PER)
    xyz = g["xyz"].reshape(-1, 3)
    opa = torch.full((xyz.shape[0],), OPACITY, dtype=torch.float32, device=device)
    return xyz, g["scale"].reshape(-1, 3), g["quat"].reshape(-1, 4), opa


def video_cameras(args, device):
    """The frames' cameras: the transforms file's (c2w with the y and z
    axes flipped) or an orbit of --n-orbit views."""
    if not args.transforms:
        return ring_cameras(args.n_orbit, args.size, args.size, device=device)
    with open(args.transforms) as f:
        tv = json.load(f)
    fovx = tv["camera_angle_x"]
    cams = []
    for fr in tv["frames"]:
        c2w = np.array(fr["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(w2c[:3, :3].T, w2c[:3, 3], fovx, fovx, args.size, args.size,
                                device=device))
    return cams


def render_curves(argv=None, quiet: bool = False) -> dict:
    """Render and write every frame.  Returns the host seconds per frame of
    the render (to the image on the host) and of the write, the SHA-256 of
    each frame's uint8 pixels as written, frame 0's float render, the frame
    directory and whether a video was stitched."""
    args = parse_args(argv)
    if args.n_devices:
        raise NotImplementedError(
            "--n-devices is the tile-parallel render, which the multi-device slice of the "
            "port (ROADMAP slice 11) brings; this script renders on one device")
    dev = resolve_device(args.device)
    with open(args.edges) as f:
        edge_dict = json.load(f)
    xyz, scale, quat, opa = edge_gaussians(edge_dict, args.width, dev)
    cams = video_cameras(args, dev)

    frame_dir = os.path.join(args.out, "frames")
    os.makedirs(frame_dir, exist_ok=True)
    render_s, write_s, digests, first = [], [], [], None
    for i, cam in enumerate(cams):
        t0 = time.time()
        with torch.no_grad():
            img = render(xyz, scale, quat, opa, cam, bg=0.0, capacity=CAPACITY)["render"]
        img = img.cpu().numpy()
        t1 = time.time()
        first = img if first is None else first
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(frame_dir, f"frame_{i:04d}.png"), u8)
        digests.append(hashlib.sha256(u8.tobytes()).hexdigest())
        render_s.append(t1 - t0)
        write_s.append(time.time() - t1)
        if not quiet:
            print(f"frame {i + 1}/{len(cams)}", end="\r", flush=True)
    video = os.path.join(args.out, "curves.mp4")
    stitched = stitch_video(frame_dir, video)
    if not quiet:
        print()
        print("wrote", video if stitched else f"{len(cams)} frames in {frame_dir} (no ffmpeg)")
    return dict(render_seconds=render_s, write_seconds=write_s, sha256=digests,
                first_frame=first, frame_dir=frame_dir, video=stitched)


if __name__ == "__main__":
    render_curves()
