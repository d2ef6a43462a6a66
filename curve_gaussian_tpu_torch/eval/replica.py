"""Replica-style qualitative evaluation, as
``curve_gaussian_tpu/eval/replica.py`` (reference
edge_extraction/eval_replica.py): no GT exists, so the harness counts the
curves and lines and projects the reconstructed edges into every view as
overlays; the frames are stitched into a video when ffmpeg is installed
(the reference shells out to ffmpeg the same way)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

import numpy as np

from ..data.png import write_png
from ..ops.camera import Camera
from .extract import host_array, sample_edge_dict


def project_points(cam: Camera, pts: np.ndarray):
    """World points [N, 3] -> (u, v, in_front) pixel coordinates."""
    proj = host_array(cam.full_proj)
    hom = pts @ proj[:3, :3].T + proj[:3, 3]
    w = pts @ proj[3, :3] + proj[3, 3]
    ok = w > 1e-6
    ndc = hom[:, :2] / np.maximum(w[:, None], 1e-6)
    u = ((ndc[:, 0] + 1) * cam.width - 1) * 0.5
    v = ((ndc[:, 1] + 1) * cam.height - 1) * 0.5
    return u, v, ok


def overlay_edges(
    edge_dict: Dict,
    cameras: Sequence[Camera],
    edge_maps: Sequence,
    out_dir: str,
    max_frames: int = 60,
    dot_radius: int = 1,
) -> List[str]:
    """Side-by-side (edge map | projected edges in red over it) RGB PNGs,
    one per view up to `max_frames`; returns their paths.  Edge maps may
    be tensors on the card; they are read on the host."""
    os.makedirs(out_dir, exist_ok=True)
    pts, _ = sample_edge_dict(edge_dict)
    paths = []
    for i, (cam, emap) in enumerate(zip(cameras, edge_maps)):
        if i >= max_frames:
            break
        h, w = cam.height, cam.width
        base = np.stack([host_array(emap)] * 3, -1)
        overlay = base.copy()
        if len(pts):
            u, v, ok = project_points(cam, pts)
            ui = np.round(u).astype(int)
            vi = np.round(v).astype(int)
            ok &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            for du in range(-dot_radius, dot_radius + 1):
                for dv in range(-dot_radius, dot_radius + 1):
                    uu = np.clip(ui[ok] + du, 0, w - 1)
                    vv = np.clip(vi[ok] + dv, 0, h - 1)
                    overlay[vv, uu] = [1.0, 0.1, 0.1]
        side = np.concatenate([base, overlay], axis=1)
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        write_png(p, (np.clip(side, 0, 1) * 255).astype(np.uint8))
        paths.append(p)
    return paths


def stitch_video(frame_dir: str, out_path: str, fps: int = 10) -> bool:
    """Stitch frame_*.png into an mp4 with ffmpeg; False when ffmpeg is not
    installed."""
    if shutil.which("ffmpeg") is None:
        return False
    subprocess.run(
        [
            "ffmpeg", "-y", "-framerate", str(fps),
            "-pattern_type", "glob", "-i", os.path.join(frame_dir, "frame_*.png"),
            "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path,
        ],
        check=True,
        capture_output=True,
    )
    return True


def evaluate_replica(
    pred_json_path: str,
    cameras: Sequence[Camera],
    edge_maps: Sequence,
    out_dir: str,
) -> Dict[str, float]:
    """Overlay frames, the video where ffmpeg exists, and stats.json (the
    curve, line and frame counts), which it also returns."""
    with open(pred_json_path) as f:
        edge_dict = json.load(f)
    frames = overlay_edges(edge_dict, cameras, edge_maps, out_dir)
    stats = {
        "n_curves": len(edge_dict.get("curves_ctl_pts", [])),
        "n_lines": len(edge_dict.get("lines_end_pts", [])),
        "n_frames": len(frames),
    }
    stitch_video(out_dir, os.path.join(out_dir, "overlay.mp4"))
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f)
    return stats
