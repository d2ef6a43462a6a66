"""PLY writers (numpy only), as ``curve_gaussian_tpu/data/ply.py``: vertex
clouds with float properties, optional normals and uchar colours, and
binary triangle meshes with vertex colours.  The reader belongs to the
dataset loaders, a later slice of the port."""
from __future__ import annotations

from typing import Optional

import numpy as np


def _uchar(colors: np.ndarray) -> np.ndarray:
    """float colours in [0, 1] (or uint8 as they are) -> uint8."""
    if colors.dtype == np.uint8:
        return colors
    return np.clip(colors * 255.0, 0, 255).astype(np.uint8)


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,  # float [0,1] or uint8
    normals: Optional[np.ndarray] = None,
    ascii: bool = False,
) -> None:
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    cols = None
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        cols = _uchar(colors)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    fmt = "ascii" if ascii else "binary_little_endian"
    header = f"ply\nformat {fmt} 1.0\nelement vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    pts = np.asarray(points, "<f4")
    nrm = np.asarray(normals, "<f4") if normals is not None else None
    with open(path, "wb") as f:
        f.write(header.encode())
        if ascii:
            for i in range(n):
                row = list(pts[i]) + (list(nrm[i]) if nrm is not None else [])
                line = " ".join(f"{v:.6f}" for v in row)
                if cols is not None:
                    line += " " + " ".join(str(int(v)) for v in cols[i])
                f.write((line + "\n").encode())
            return
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if nrm is not None:
            fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if cols is not None:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        rec = np.empty(n, dtype=fields)
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        if nrm is not None:
            rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        if cols is not None:
            rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
        f.write(rec.tobytes())


def write_ply_mesh(
    path: str,
    vertices: np.ndarray,  # [V, 3]
    faces: np.ndarray,  # [F, 3] int
    colors: Optional[np.ndarray] = None,  # per-vertex, float [0,1] or uint8
) -> None:
    """Binary triangle-mesh PLY (vertex colours optional)."""
    n, nf = len(vertices), len(faces)
    props = ["property float x", "property float y", "property float z"]
    cols = None
    if colors is not None:
        cols = _uchar(colors)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
        + "\n".join(props)
        + f"\nelement face {nf}\nproperty list uchar int vertex_indices\n"
        + "end_header\n"
    )
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if cols is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=fields)
    pts = np.asarray(vertices, "<f4")
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if cols is not None:
        rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
    frec = np.empty(nf, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    frec["n"] = 3
    frec["idx"] = np.asarray(faces, "<i4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())
        f.write(frec.tobytes())
