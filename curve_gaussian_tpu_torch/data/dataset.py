"""Scene loading, as ``curve_gaussian_tpu/data/dataset.py``: EMAP, Blender
and COLMAP datasets with edge-map substitution.

The dataset type is dispatched on marker files (the reference's
scene/__init__.py:45-58):

    sparse/                -> COLMAP
    transforms_train.json  -> Blender (NeRF-synthetic / ABC-NEF)
    meta_data.json         -> EMAP (the main ABC path)

Edge detections stand in for RGB: image paths under images/, color/ or
train/ are rewritten to edge_DexiNed/ or edge_PidiNet/
(dataset_readers.py:112-121, 274-276, 310-317).  Edge maps load as
single-channel float32 [H, W] numpy arrays in [0, 1], the cameras as the
port's ``Camera`` tensors on the loader's device.  PNGs are read and
resized by ``data/png.py`` (bitwise what PIL gives the JAX loader), so the
port needs no PIL.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..config import ModelConfig
from ..ops.camera import Camera, focal2fov, fov2focal, make_camera
from . import colmap as colmap_mod
from .png import read_png, resize_bicubic_u8
from .synthetic import grid_seed_points


@dataclasses.dataclass
class LoadedScene:
    train_cameras: List[Camera]
    train_edge_maps: List[np.ndarray]
    test_cameras: List[Camera]
    test_edge_maps: List[np.ndarray]
    seed_points: np.ndarray
    cameras_extent: float


def _load_edge_image(path: str, resolution: int, orig_w: Optional[int] = None):
    """(edge map as [H, W] float32 in [0, 1], the file's (width, height)).
    The map is the first channel (like gt_image[:1]), resized by Pillow's
    bicubic filter unless the divisor of `resolution` for `orig_w` (the
    file's width by default) is 1."""
    img = read_png(path)
    h0, w0 = img.shape[:2]
    div = _resolution_divisor(resolution, w0 if orig_w is None else orig_w)
    if div and div != 1:
        img = resize_bicubic_u8(img, round(w0 / div), round(h0 / div))
    arr = img.astype(np.float32) / 255.0
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr, (w0, h0)


def apply_edge_polarity(maps: List[np.ndarray], mode: str) -> List[np.ndarray]:
    """Edge maps as bright edges on a dark background.

    Detector dumps vary in polarity (the reference inverts DexiNed maps in
    places, edge_extraction/extract_para_edge.py:49-53), and the renderer
    composites bright splats over a dark background.  `mode`: "on" always
    inverts, "off" never, "auto" when the scene-level mean intensity
    exceeds 0.6 (edges are sparse: a white-background map averages ~0.85+,
    a bright-on-dark one well under 0.5).  Scene-level, so all views agree
    even if one frame is nearly empty.
    """
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"invert_edges={mode!r} not in ('auto','on','off')")
    if not maps:
        return maps
    invert = mode == "on" or (
        mode == "auto" and float(np.mean([float(m.mean()) for m in maps])) > 0.6)
    if invert:
        print("edge maps look dark-on-white (scene mean intensity > 0.6): "
              "inverting to bright-on-dark", flush=True)
        maps = [1.0 - m for m in maps]
    return maps


def _resolution_divisor(resolution: int, orig_w: int) -> float:
    """utils/camera_utils.py:22-42 semantics."""
    if resolution in (1, 2, 3, 4, 8):
        return float(resolution)
    if resolution == -1:
        return orig_w / 1600.0 if orig_w > 1600 else 1.0
    return orig_w / float(resolution)


def _edge_path(image_path: str, detector: str) -> str:
    for src in ("images", "color", "train"):
        cand = image_path.replace(f"/{src}/", f"/edge_{detector}/")
        if cand != image_path:
            image_path = cand
            break
    base, _ = os.path.splitext(image_path)
    return base + ".png"


def _nerfpp_extent(cam_centers: np.ndarray) -> float:
    """getNerfppNorm radius (dataset_readers.py:51-72)."""
    center = cam_centers.mean(axis=0, keepdims=True)
    return float(np.linalg.norm(cam_centers - center, axis=1).max() * 1.1)


def _scene(cams, maps, centers, seed, cfg: ModelConfig) -> LoadedScene:
    """EMAP and Blender: every view trains, and with --eval every view is
    also a test view."""
    maps = apply_edge_polarity(maps, cfg.invert_edges)
    test_cams, test_maps = (cams, maps) if cfg.eval else ([], [])
    return LoadedScene(train_cameras=cams, train_edge_maps=maps, test_cameras=test_cams,
                       test_edge_maps=test_maps, seed_points=seed,
                       cameras_extent=_nerfpp_extent(np.array(centers)))


def load_emap(cfg: ModelConfig, device="cuda") -> LoadedScene:
    """meta_data.json scenes (dataset_readers.py:290-329, 385-456)."""
    dev = resolve_device(device)
    path = cfg.source_path
    with open(os.path.join(path, "meta_data.json")) as f:
        meta = json.load(f)
    cams, maps, centers = [], [], []
    for frame in meta["frames"]:
        c2w = np.array(frame["camtoworld"], dtype=np.float64)
        K = np.array(frame["intrinsics"], dtype=np.float64)
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        epath = _edge_path(os.path.join(path, "color", frame["rgb_path"]), cfg.detector)
        edge, (w0, h0) = _load_edge_image(epath, cfg.resolution)
        h, w = edge.shape
        fovx = focal2fov(K[0, 0], w0)
        fovy = focal2fov(K[1, 1], h0)
        cams.append(make_camera(R, T, fovx, fovy, h, w, device=dev))
        maps.append(edge)
        centers.append(c2w[:3, 3])
    return _scene(cams, maps, centers, _emap_seed_points(path), cfg)


def _emap_seed_points(path: str) -> np.ndarray:
    """EMAP seed cloud: the 15^3 grid by default; when the scene ships
    sparse SfM points (dataset_readers.py:414-439 non-default branch) they
    are used instead, replicated with jitter up to ~8k points if sparse."""
    sfm = os.path.join(path, "sparse_sfm_points.txt")
    if not os.path.exists(sfm):
        return grid_seed_points(15)
    xyz = np.loadtxt(sfm).reshape(-1, 3).astype(np.float32)
    target = 8001
    if len(xyz) < target:
        reps = -(-(target - len(xyz)) // max(len(xyz), 1))
        rng = np.random.default_rng(0)
        extra = np.concatenate([xyz] * reps) + 0.1 * rng.random(
            (reps * len(xyz), 3), dtype=np.float32)
        xyz = np.concatenate([xyz, extra])[:target]
    return xyz


def load_blender(cfg: ModelConfig, device="cuda") -> LoadedScene:
    """transforms_train.json scenes (dataset_readers.py:251-382)."""
    dev = resolve_device(device)
    path = cfg.source_path
    with open(os.path.join(path, "transforms_train.json")) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    cams, maps, centers = [], [], []
    for frame in meta["frames"]:
        img_path = os.path.join(path, frame["file_path"] + ".png")
        epath = _edge_path(img_path.replace("ABC-NEF/", "ABC-NEF_Edge/data/"), cfg.detector)
        if not os.path.exists(epath):
            epath = _edge_path(img_path, cfg.detector)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        edge, (w0, h0) = _load_edge_image(epath, cfg.resolution)
        h, w = edge.shape
        fovy = focal2fov(fov2focal(fovx, w0), h0)
        cams.append(make_camera(R, T, fovx, fovy, h, w, device=dev))
        maps.append(edge)
        centers.append(c2w[:3, 3])
    return _scene(cams, maps, centers, grid_seed_points(15), cfg)


def load_colmap(cfg: ModelConfig, llffhold: int = 8, device="cuda") -> LoadedScene:
    """COLMAP scenes with edge substitution (dataset_readers.py:74-249).
    With --eval every `llffhold`-th image by name is also a test view; like
    the JAX loader, the test views stay in the training set."""
    dev = resolve_device(device)
    path = cfg.source_path
    cams_intr, imgs, pts, _ = colmap_mod.load_sparse(path)
    names = sorted(imgs.keys(), key=lambda k: imgs[k].name)
    train_cams, train_maps, test_cams, test_maps, centers = [], [], [], [], []
    sorted_names = sorted(imgs[k].name for k in imgs)
    test_names = set(
        name for i, name in enumerate(sorted_names) if cfg.eval and i % llffhold == 0)
    for key in names:
        im = imgs[key]
        intr = cams_intr[im.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model in ("PINHOLE", "OPENCV"):
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(f"unsupported COLMAP camera model {intr.model}")
        R = colmap_mod.qvec2rotmat(im.qvec).T
        T = im.tvec
        epath = _edge_path(os.path.join(path, cfg.images, im.name), cfg.detector)
        edge, _ = _load_edge_image(epath, cfg.resolution, intr.width)
        h, w = edge.shape
        fovx = focal2fov(fx, intr.width)
        fovy = focal2fov(fy, intr.height)
        cam = make_camera(R, T, fovx, fovy, h, w, device=dev)
        w2c = np.eye(4)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = T
        centers.append(np.linalg.inv(w2c)[:3, 3])
        if im.name in test_names:
            test_cams.append(cam)
            test_maps.append(edge)
        train_cams.append(cam)
        train_maps.append(edge)
    seed = pts.astype(np.float32) if len(pts) else grid_seed_points(15)
    return LoadedScene(
        train_cameras=train_cams,
        train_edge_maps=apply_edge_polarity(train_maps, cfg.invert_edges),
        test_cameras=test_cams,
        test_edge_maps=apply_edge_polarity(test_maps, cfg.invert_edges),
        seed_points=seed,
        cameras_extent=_nerfpp_extent(np.array(centers)),
    )


def load_scene(cfg: ModelConfig, device="cuda") -> LoadedScene:
    """Marker-file dispatch (scene/__init__.py:45-58)."""
    path = cfg.source_path
    if os.path.exists(os.path.join(path, "sparse")):
        return load_colmap(cfg, device=device)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return load_blender(cfg, device=device)
    if os.path.exists(os.path.join(path, "meta_data.json")):
        return load_emap(cfg, device=device)
    raise ValueError(f"could not recognize scene type for {path}")
