"""Render fitted parametric curves along a camera path (a novel-view video),
as the repository's ``scripts/render_curves.py`` does with the JAX package.

Reads ``parametric_edges.json`` (lines become cubic control points), samples
each edge into 32 Gaussians of the given width at opacity 0.95
(``bezier.curve_gaussians``) and splats every view with the port's render at
its default channel set (K3 on the card, one launch per frame).  The
frames share one render body (``engine/train.py::render_views``): on the
card it is captured once as a CUDA graph and replayed once per frame, each
frame's camera picked from device stacks by a counter; on the CPU it runs
eagerly.  The cameras are an orbit (``ring_cameras``) or a NeRF-style
``transforms_video.json``.  Frames land in <out>/frames/ and are stitched
to <out>/curves.mp4 when ffmpeg is installed.  With ``--n-devices N`` each
frame is the tile-parallel render (``parallel/sharding.py::
tile_parallel_renders``: each rank's band captured, with the sum inside
the graph over NCCL and eager between the replays over gloo) over the N
ranks of the process group (``torchrun --nproc-per-node N``, as
``train.py`` runs), and rank 0 writes the frames.

    python -m curve_gaussian_tpu_torch.scripts.render_curves --edges <run>/parametric_edges.json
    python -m curve_gaussian_tpu_torch.scripts.render_curves --edges ... --device cpu --size 64
    torchrun --nproc-per-node 2 -m curve_gaussian_tpu_torch.scripts.render_curves \
        --edges ... --n-devices 2
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.png import write_png
from ..data.synthetic import ring_cameras
from ..engine.train import RenderGraphs, camera_stacks, render_views
from ..eval.replica import stitch_video
from ..ops import bezier
from ..ops.camera import make_camera
from ..ops.render import render
from ..parallel import multihost
from ..parallel.sharding import make_mesh, tile_parallel_renders

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
                   help="tile-parallel rendering over N devices, the ranks of the process "
                        "group (one process each)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--dist-backend", default=None, choices=[None, "nccl", "gloo"],
                   help="torch.distributed backend with more than one process (default: "
                        "nccl on CUDA, gloo on the CPU); nccl needs one card per rank and "
                        "captures the collectives in the CUDA graphs, gloo is for ranks "
                        "that share a card (or the CPU)")
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


def frame_render(gauss: dict, cam) -> torch.Tensor:
    """One frame's render [H, W] of the edges' Gaussians, eagerly: what
    every frame of ``render_curves`` computes."""
    return render(gauss["xyz"], gauss["scale"], gauss["quat"], gauss["opacity"], cam, bg=0.0,
                  capacity=CAPACITY)["render"]


def frame_u8(img: np.ndarray) -> np.ndarray:
    """A frame's float render as the uint8 pixels written (and hashed)."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_curves(argv=None, quiet: bool = False) -> dict:
    """Render and write every frame.  Returns the host seconds per frame of
    the render (to the image on the host; frame 0's includes the capture on
    the card) and of the write, the SHA-256 of each frame's uint8 pixels as
    written, frame 0's float render, the frame directory, whether a video
    was stitched, and the render graphs (released: their captures and
    replays).  With ``--n-devices`` every rank renders and returns the same;
    only rank 0 writes (its write seconds are 0 elsewhere)."""
    args = parse_args(argv)
    with multihost.distributed(args.device, args.dist_backend) as dev:
        return _render_frames(args, dev, quiet)


def _render_frames(args, dev, quiet: bool) -> dict:
    mesh = make_mesh(args.n_devices, device=dev) if args.n_devices else None
    rank0 = mesh is None or mesh.rank == 0
    quiet = quiet or not rank0
    pipe = PipelineConfig(tile_capacity=CAPACITY)
    with open(args.edges) as f:
        edge_dict = json.load(f)
    xyz, scale, quat, opa = edge_gaussians(edge_dict, args.width, dev)
    gauss = {"xyz": xyz, "scale": scale, "quat": quat, "opacity": opa}
    cams = video_cameras(args, dev)
    stacks = camera_stacks(cams, torch.float32, dev)
    geom = (cams[0].height, cams[0].width, cams[0].tanfovx, cams[0].tanfovy)
    graphs = RenderGraphs()
    if mesh is None:
        frames = (out["render"] for _, out in render_views(
            lambda g, cam: {"render": frame_render(g, cam)}, gauss, stacks, geom,
            range(len(cams)), ("render_curves", CAPACITY), graphs))
    else:
        frames = tile_parallel_renders(gauss, stacks, geom, pipe, 0.0, mesh.shape,
                                       range(len(cams)), graphs)

    frame_dir = os.path.join(args.out, "frames")
    if rank0:
        os.makedirs(frame_dir, exist_ok=True)
    render_s, write_s, digests, first = [], [], [], None
    for i in range(len(cams)):
        t0 = time.time()
        img = next(frames).cpu().numpy()
        t1 = time.time()
        first = img if first is None else first
        u8 = frame_u8(img)
        if rank0:
            write_png(os.path.join(frame_dir, f"frame_{i:04d}.png"), u8)
        digests.append(hashlib.sha256(u8.tobytes()).hexdigest())
        render_s.append(t1 - t0)
        write_s.append(time.time() - t1)
        if not quiet:
            print(f"frame {i + 1}/{len(cams)}", end="\r", flush=True)
    graphs.release()
    video = os.path.join(args.out, "curves.mp4")
    stitched = rank0 and stitch_video(frame_dir, video)
    if not quiet:
        print()
        print("wrote", video if stitched else f"{len(cams)} frames in {frame_dir} (no ffmpeg)")
    return dict(render_seconds=render_s, write_seconds=write_s, sha256=digests,
                first_frame=first, frame_dir=frame_dir, video=stitched, graphs=graphs)


if __name__ == "__main__":
    render_curves()
