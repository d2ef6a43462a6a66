"""PLY files (numpy only), as ``curve_gaussian_tpu/data/ply.py``: vertex
clouds with float properties, optional normals and uchar colours, binary
triangle meshes with vertex colours, and the vertex reader."""
from __future__ import annotations

from typing import Dict, Optional

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


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """The vertices of an ascii or binary PLY: 'points' [N, 3] and, where
    the file has them, 'colors' (float [0, 1]) and 'normals'."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    fmt, n, props, in_vertex = "ascii", 0, [], False
    for line in data[:header_end].decode("ascii", "replace").splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            props.append((t[2], t[1]))
    typemap = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
               "int": "<i4", "int32": "<i4", "ushort": "<u2", "short": "<i2"}
    if fmt == "ascii":
        arr = np.array(data[header_end:].decode().split(), float).reshape(n, len(props))
        cols = {name: arr[:, i] for i, (name, _) in enumerate(props)}
    else:
        dt = np.dtype([(name, typemap[t]) for name, t in props])
        rec = np.frombuffer(data[header_end:header_end + n * dt.itemsize], dt)
        cols = {name: rec[name].astype(np.float64) for name, _ in props}
    out = {"points": np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)}
    if "red" in cols:
        scale = 255.0 if max(cols["red"].max(initial=0), 1) > 1 else 1.0
        out["colors"] = (np.stack([cols["red"], cols["green"], cols["blue"]], 1)
                         / scale).astype(np.float32)
    if "nx" in cols:
        out["normals"] = np.stack([cols["nx"], cols["ny"], cols["nz"]], 1).astype(np.float32)
    return out


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
