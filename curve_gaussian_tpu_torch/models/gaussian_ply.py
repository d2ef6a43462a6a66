"""3DGS-format Gaussian PLY export and import for viewers, as
``curve_gaussian_tpu/models/gaussian_ply.py``: x, y, z, nx, ny, nz,
f_dc_*, opacity (inverse sigmoid), scale_* (log) and rot_* (w, x, y, z).
Import gives the raw per-Gaussian attributes for render-only use: curves
cannot be recovered from such a cloud; the npz checkpoints hold the
model."""
from __future__ import annotations

from typing import Dict

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


def load_gaussian_ply(path: str) -> Dict[str, np.ndarray]:
    """The Gaussians of a PLY written by ``save_gaussian_ply`` (or a 3DGS
    tool with the same layout): xyz, opacity (sigmoid), scale (exp), quat
    and features_dc (the f_dc_* columns in the JAX package's order).  Raises
    ValueError on any other layout: a format other than binary little-endian,
    an element other than one ``vertex``, a property that is not a 4-byte
    float, or a body shorter than the header says."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if not data.startswith(b"ply\n") or header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header_end += len(b"end_header\n")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: only binary little-endian PLY is read")
    elements = [ln.split() for ln in header if ln.startswith("element")]
    if len(elements) != 1 or elements[0][1] != "vertex":
        raise ValueError(f"{path}: expected one 'vertex' element, got {elements}")
    props = [ln.split() for ln in header if ln.startswith("property")]
    bad = [p for p in props if len(p) != 3 or p[1] not in ("float", "float32")]
    if bad:
        raise ValueError(f"{path}: properties must be 4-byte floats, got {bad}")
    names = [p[2] for p in props]
    n = int(elements[0][2])
    body = data[header_end:header_end + n * len(names) * 4]
    if len(body) != n * len(names) * 4:
        raise ValueError(f"{path}: body holds {len(body)} bytes, the header says "
                         f"{n * len(names) * 4}")
    arr = np.frombuffer(body, "<f4").reshape(n, len(names))
    col = {name: arr[:, i] for i, name in enumerate(names)}
    dc = [k for k in names if k.startswith("f_dc_")]
    return {
        "xyz": np.stack([col["x"], col["y"], col["z"]], 1),
        "opacity": 1.0 / (1.0 + np.exp(-col["opacity"])),
        "scale": np.exp(np.stack([col[f"scale_{i}"] for i in range(3)], 1)),
        "quat": np.stack([col[f"rot_{i}"] for i in range(4)], 1),
        "features_dc": (np.stack([col[k] for k in sorted(dc)], 1) if dc
                        else np.zeros((n, 1), np.float32)),
    }
