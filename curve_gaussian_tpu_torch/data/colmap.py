"""COLMAP sparse-reconstruction parsers (binary + text), numpy only, as
``curve_gaussian_tpu/data/colmap.py``: cameras, images and points3D, the
surface the reference's scene/colmap_loader.py:83-293 covers.  The port
keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            _read(f, 8, "Q")  # id
            xyz.append(_read(f, 24, "ddd"))
            rgb.append(_read(f, 3, "BBB"))
            err.append(_read(f, 8, "d"))
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return (
        np.array(xyz),
        np.array(rgb),
        np.array(err).reshape(-1, 1),
    )


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            out[int(t[0])] = ColmapCamera(
                int(t[0]), t[1], int(t[2]), int(t[3]), np.array(t[4:], float)
            )
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [
            l.strip() for l in f if l.strip() and not l.strip().startswith("#")
        ]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        t = lines[i].split()
        out[int(t[0])] = ColmapImage(
            int(t[0]),
            np.array(t[1:5], float),
            np.array(t[5:8], float),
            int(t[8]),
            t[9],
        )
    return out


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            xyz.append([float(v) for v in t[1:4]])
            rgb.append([int(v) for v in t[4:7]])
            err.append(float(t[7]))
    return np.array(xyz), np.array(rgb), np.array(err).reshape(-1, 1)


def load_sparse(path: str):
    """Read cameras+images+points from <path>/sparse/0 (binary or text)."""
    base = os.path.join(path, "sparse", "0")
    try:
        cams = read_cameras_binary(os.path.join(base, "cameras.bin"))
        imgs = read_images_binary(os.path.join(base, "images.bin"))
    except FileNotFoundError:
        cams = read_cameras_text(os.path.join(base, "cameras.txt"))
        imgs = read_images_text(os.path.join(base, "images.txt"))
    try:
        pts, rgb, _ = read_points3d_binary(os.path.join(base, "points3D.bin"))
    except FileNotFoundError:
        try:
            pts, rgb, _ = read_points3d_text(os.path.join(base, "points3D.txt"))
        except FileNotFoundError:
            pts, rgb = np.zeros((0, 3)), np.zeros((0, 3))
    return cams, imgs, pts, rgb
