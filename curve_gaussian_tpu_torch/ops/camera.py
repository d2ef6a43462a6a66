"""Camera model and projection matrices.

Matrices act on column vectors (p' = M @ p_hom), znear/zfar = 0.01 / 100, as
in ``curve_gaussian_tpu/ops/camera.py``.  The matrices are built in float64
numpy and cast once to the camera's tensor type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device

ZNEAR = 0.01
ZFAR = 100.0


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def world_to_cam_matrix(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """[[R^T, T], [0, 1]] for the readers' transposed-R convention."""
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = T
    w2c[3, 3] = 1.0
    return w2c


def perspective_matrix(
    fovx: float, fovy: float, znear: float = ZNEAR, zfar: float = ZFAR
) -> np.ndarray:
    """OpenGL-style perspective with w' = z; NDC x, y in [-1, 1]."""
    tx = math.tan(fovx / 2.0)
    ty = math.tan(fovy / 2.0)
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view: three tensors plus static image geometry.

    ``intrinsics``, when set, holds ``projection.intrinsics`` of the view
    as a [4] tensor in the state's dtype, and the projection reads it in
    place of the values it derives from ``tanfovx``/``tanfovy``: a step
    replayed from a CUDA graph (``engine/train.py::train_steps_scan``)
    selects each view's row from a device stack."""

    world_to_cam: torch.Tensor  # [4,4] p_cam = world_to_cam @ p_hom
    full_proj: torch.Tensor  # [4,4] = perspective @ world_to_cam
    cam_center: torch.Tensor  # [3]
    height: int
    width: int
    tanfovx: float
    tanfovy: float
    intrinsics: Optional[torch.Tensor] = None

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tanfovy)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    height: int,
    width: int,
    dtype=torch.float32,
    device="cuda",
) -> Camera:
    dev = resolve_device(device)
    w2c = world_to_cam_matrix(np.asarray(R), np.asarray(T))
    proj = perspective_matrix(fovx, fovy) @ w2c
    c2w = np.linalg.inv(w2c)
    return Camera(
        world_to_cam=torch.tensor(w2c, dtype=dtype, device=dev),
        full_proj=torch.tensor(proj, dtype=dtype, device=dev),
        cam_center=torch.tensor(c2w[:3, 3], dtype=dtype, device=dev),
        height=int(height),
        width=int(width),
        tanfovx=float(math.tan(fovx / 2.0)),
        tanfovy=float(math.tan(fovy / 2.0)),
    )


def look_at_camera(
    eye,
    target,
    up=(0.0, 1.0, 0.0),
    fovx: float = math.radians(50.0),
    height: int = 256,
    width: int = 256,
    fovy: Optional[float] = None,
    dtype=torch.float32,
    device="cuda",
) -> Camera:
    """Camera at `eye` looking at `target` (x right, y down, z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=0)  # world->cam rotation
    T = -Rcw @ eye
    if fovy is None:
        fovy = focal2fov(fov2focal(fovx, width), height)
    return make_camera(
        Rcw.T, T, fovx, fovy, height, width, dtype=dtype, device=device
    )


def stack_cameras(cams: list) -> Camera:
    """Stack per-view tensors into a leading batch axis (views of one
    height, width and field of view); ``intrinsics`` is stacked when every
    view has it."""
    h, w = cams[0].height, cams[0].width
    if not all(c.height == h and c.width == w for c in cams):
        raise ValueError("stack_cameras needs views of one image size")
    intr = None
    if all(c.intrinsics is not None for c in cams):
        intr = torch.stack([c.intrinsics for c in cams])
    return Camera(
        world_to_cam=torch.stack([c.world_to_cam for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        cam_center=torch.stack([c.cam_center for c in cams]),
        height=h,
        width=w,
        tanfovx=cams[0].tanfovx,
        tanfovy=cams[0].tanfovy,
        intrinsics=intr,
    )


def index_camera(cams: Camera, i) -> Camera:
    """View `i` of a stacked Camera (tensor indexing: an int selects a view
    of the stacks, no host read)."""
    return Camera(
        world_to_cam=cams.world_to_cam[i],
        full_proj=cams.full_proj[i],
        cam_center=cams.cam_center[i],
        height=cams.height,
        width=cams.width,
        tanfovx=cams.tanfovx,
        tanfovy=cams.tanfovy,
        intrinsics=None if cams.intrinsics is None else cams.intrinsics[i],
    )
