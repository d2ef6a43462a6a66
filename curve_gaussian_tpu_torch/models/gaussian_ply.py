"""3DGS-format Gaussian PLY export for viewers, as
``curve_gaussian_tpu/models/gaussian_ply.py``: x, y, z, nx, ny, nz,
f_dc_*, opacity (inverse sigmoid), scale_* (log) and rot_* (w, x, y, z).
Curves cannot be recovered from such a cloud; the npz checkpoints hold the
model."""
from __future__ import annotations

import numpy as np


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,  # [P,3]
    opacity: np.ndarray,  # [P] in (0,1)
    scale: np.ndarray,  # [P,3] linear
    quat: np.ndarray,  # [P,4] (w,x,y,z)
    features_dc: np.ndarray | None = None,  # [P, C]
) -> None:
    P = len(xyz)
    if features_dc is None:
        features_dc = np.zeros((P, 1), np.float32)
    C = features_dc.shape[1]
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(C)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {P}\n"
        + "".join(f"property float {n}\n" for n in names)
        + "end_header\n"
    )
    o = np.clip(opacity, 1e-7, 1 - 1e-7)
    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), features_dc, np.log(o / (1 - o))[:, None],
         np.log(np.maximum(scale, 1e-9)), quat],
        axis=1,
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(cols).tobytes())
