"""Parity of the port's data path with ``curve_gaussian_tpu``'s: the PNG
reader and the bicubic resize against Pillow (bitwise), the COLMAP and PLY
readers, the EMAP, Blender and COLMAP loaders on fixture scenes written
here, the scene maker against the JAX script, and the CLI on a dataset
scene.

The loaders must give the JAX loaders' edge maps and seed points bitwise,
the extent within 1e-12, the image sizes and fields of view exactly, and
the camera matrices (float32 tensors on both sides) within 1e-6 of each
array's max.  PIL is the oracle here; the port never imports it.
"""
import importlib.util
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from curve_gaussian_tpu.data import colmap as jcolmap
from curve_gaussian_tpu.data import dataset as jdata
from curve_gaussian_tpu.data import ply as jply
from curve_gaussian_tpu.config import ModelConfig as JModel

from curve_gaussian_tpu_torch import train as ptrain_cli
from curve_gaussian_tpu_torch.config import ModelConfig
from curve_gaussian_tpu_torch.data import colmap as pcolmap
from curve_gaussian_tpu_torch.data import dataset as pdata
from curve_gaussian_tpu_torch.data import ply as pply
from curve_gaussian_tpu_torch.data.png import read_png, resize_bicubic_u8, write_png
from curve_gaussian_tpu_torch.scripts.make_ref_scale_scene import make_ref_scale_scene

ROOT = Path(__file__).resolve().parent.parent
H, W = 56, 40  # fixture images: rows, columns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the module from
    contending for the cores the suite's other workers use."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- PNG ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(path, img, filters, color, depth=8, interlace=0):
    """A PNG of uint8 `img` with the given filter type on each row and its
    IDAT split in two chunks (a transcription of the PNG specification)."""
    h = img.shape[0]
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    x = img.reshape(h, -1).astype(int)
    prev, rows = np.zeros(x.shape[1], int), []
    for y in range(h):
        f, cur, out = filters[y % len(filters)], x[y], [filters[y % len(filters)]]
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2, _paeth(a, prev[i], c))[f]
            out.append((cur[i] - pred) % 256)
        rows.append(bytes(out))
        prev = cur
    z = zlib.compress(b"".join(rows))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, depth, color, 0, 0,
                                           interlace)))
        f.write(chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:]))
        f.write(chunk(b"IEND", b""))


def _edge_like(rng, h, w, c=None):
    """Sparse bright strokes on black, as an edge detector writes them."""
    m = ((rng.uniform(size=(h, w)) > 0.85) * rng.integers(30, 256, (h, w))).astype(np.uint8)
    if c is None:
        return m
    colour = [m, m // 2, 255 - m][:1 if c == 2 else 3]
    return np.stack(colour + [np.full_like(m, 255)] * (c in (2, 4)), axis=-1)  # opaque alpha


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_read_png_equals_pil(tmp_path, mode):
    """PIL's own files (its adaptive filters use Sub, Up and Paeth on noisy
    rows, None on sparse ones), dense noise and a sparse edge map."""
    rng = np.random.default_rng(1)
    c = len(mode)
    for k, img in enumerate((rng.integers(0, 256, (37, 53, c), dtype=np.uint8),
                             _edge_like(rng, 400, 300, c if c > 1 else None))):
        img = img[..., 0] if img.ndim == 3 and c == 1 else img
        p = tmp_path / f"{mode}{k}.png"
        Image.fromarray(img, mode).save(p)
        ref = np.asarray(Image.open(p))
        got = read_png(str(p))
        assert got.dtype == np.uint8 and got.shape == ref.shape and np.array_equal(got, ref)


def test_read_png_of_write_png(tmp_path):
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (31, 17), dtype=np.uint8),
                rng.integers(0, 256, (9, 26, 3), dtype=np.uint8)):
        p = tmp_path / f"w{img.ndim}.png"
        write_png(str(p), img)
        assert np.array_equal(read_png(str(p)), img)
        assert np.array_equal(np.asarray(Image.open(p)), img)


@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_read_png_every_filter_and_split_idat(tmp_path, color):
    """Rows filtered None, Sub, Up, Average and Paeth in turn, the IDAT in
    two chunks: the image comes back whole, and PIL agrees."""
    rng = np.random.default_rng(color)
    c = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    img = rng.integers(0, 256, (15, 13, c), dtype=np.uint8)
    img[:, 4:9] //= 7  # smooth stretches next to noise
    img = img[..., 0] if c == 1 else img
    p = tmp_path / "filters.png"
    encode_png(p, img, [0, 1, 2, 3, 4, 4, 3, 2, 1], color)
    assert np.array_equal(read_png(str(p)), img)
    assert np.array_equal(np.asarray(Image.open(p)), img)
    only_sub_up = tmp_path / "subup.png"  # the row-vector path alone
    encode_png(only_sub_up, img, [1, 2, 0, 2, 1], color)
    assert np.array_equal(read_png(str(only_sub_up)), img)


def test_read_png_refuses_what_it_cannot_read_exactly(tmp_path):
    """Palette, 16-bit, 1-bit and interlaced files raise and name the file."""
    rng = np.random.default_rng(3)
    g = rng.integers(0, 256, (12, 10), dtype=np.uint8)
    files = {
        "palette.png": lambda p: Image.fromarray(g).convert("P").save(p),
        "sixteen.png": lambda p: Image.fromarray(g.astype(np.uint16) * 257).save(p),
        "onebit.png": lambda p: Image.fromarray(g > 128).save(p),
        "interlaced.png": lambda p: encode_png(p, g, [0], 0, interlace=1),
    }
    for name, make in files.items():
        p = tmp_path / name
        make(p)
        with pytest.raises(ValueError, match=name):
            read_png(str(p))


RESIZES = [  # (rows, columns, channels), (width, height) of the result
    ((56, 40, 0), (20, 28)),  # -r 2
    ((56, 40, 0), (13, 19)),  # -r 3: round(40 / 3), round(56 / 3)
    ((56, 40, 3), (10, 14)),  # -r 4
    ((56, 40, 0), (5, 7)),  # -r 8
    ((33, 80, 0), (37, 15)),  # -r 37 on an 80-wide image: divisor 80 / 37
    ((57, 41, 2), (14, 19)),  # odd sizes, grey + opaque alpha
    ((20, 30, 4), (61, 47)),  # upscale, RGBA with opaque alpha
]


@pytest.mark.parametrize("case", range(len(RESIZES)))
def test_resize_equals_pillow_bicubic(case):
    (h, w, c), (ow, oh) = RESIZES[case]
    rng = np.random.default_rng(case)
    img = _edge_like(rng, h, w, c or None)
    got = resize_bicubic_u8(img, ow, oh)
    ref = np.asarray(Image.fromarray(img).resize((ow, oh)))
    assert got.shape == ref.shape and np.array_equal(got, ref)


def test_resize_refuses_translucent_alpha():
    img = _edge_like(np.random.default_rng(0), 20, 20, 4)
    img[3, 4, 3] = 100
    with pytest.raises(ValueError, match="alpha"):
        resize_bicubic_u8(img, 10, 10)
    assert np.array_equal(resize_bicubic_u8(img, 20, 20), img)  # no resize, no refusal


# -- fixture scenes ----------------------------------------------------------------

def _look_at(eye, target=(0.5, 0.5, 0.5)):
    """World-to-camera rotation (rows right, down, forward) and translation."""
    eye = np.asarray(eye, float)
    fwd = np.asarray(target, float) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return R, -R @ eye


def _eyes(n, radius=2.2):
    t = 2 * np.pi * np.arange(n) / n
    return np.stack([0.5 + radius * np.cos(t), 0.5 + 0.3 * np.sin(3 * t),
                     0.5 + radius * np.sin(t)], axis=1)


def _c2w(eye):
    R, T = _look_at(eye)
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = R.T, eye
    return m


def _save_map(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _maps(seed, n, c=None, dark=False):
    rng = np.random.default_rng(seed)
    out = [_edge_like(rng, H, W, c) for _ in range(n)]
    return [255 - m for m in out] if dark else out


def write_emap(root, n=4, c=None, dark=False, sfm=False):
    frames = []
    for i, (eye, m) in enumerate(zip(_eyes(n), _maps(10, n, c, dark))):
        _save_map(os.path.join(root, "edge_DexiNed", f"{i:04d}.png"), m)
        K = [[52.0 + i, 0.0, W / 2], [0.0, 50.0 - i, H / 2], [0.0, 0.0, 1.0]]
        frames.append(dict(rgb_path=f"{i:04d}.jpg", camtoworld=_c2w(eye).tolist(),
                           intrinsics=K))
    with open(os.path.join(root, "meta_data.json"), "w") as f:
        json.dump(dict(height=H, width=W, frames=frames), f)
    if sfm:
        pts = np.random.default_rng(5).uniform(0.1, 0.9, size=(37, 3))
        np.savetxt(os.path.join(root, "sparse_sfm_points.txt"), pts)


def write_blender(root, edge_root, n=3, dark=False, seed=20):
    frames = []
    for i, (eye, m) in enumerate(zip(_eyes(n), _maps(seed, n, dark=dark))):
        _save_map(os.path.join(edge_root, "edge_DexiNed", f"r_{i}.png"), m)
        c2w = _c2w(eye)
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, as the format stores them
        frames.append(dict(file_path=f"./train/r_{i}", transform_matrix=c2w.tolist()))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(dict(camera_angle_x=0.7, frames=frames), f)


def _qvec(R):
    """A unit quaternion (w, x, y, z) of rotation matrix R."""
    w = np.sqrt(max(0.0, 1.0 + np.trace(R))) / 2
    x = np.copysign(np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


COLMAP_CAMERAS = [  # id, model, params
    (1, "SIMPLE_PINHOLE", [51.0, W / 2, H / 2]),
    (2, "PINHOLE", [49.0, 53.0, W / 2, H / 2]),
    (3, "OPENCV", [50.0, 52.0, W / 2, H / 2, 0.01, -0.002, 0.0005, 0.0001]),
]
MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "OPENCV": 4}


def write_colmap(root, n=9, binary=True, points=24, dark=False, maps=None):
    """n views named out of id order over three camera models, optional
    points3D; edge maps under edge_DexiNed/ for images/img_XXX.jpg."""
    base = os.path.join(root, "sparse", "0")
    os.makedirs(base, exist_ok=True)
    maps = maps if maps is not None else _maps(30, n, dark=dark)
    ids = np.random.default_rng(7).permutation(n) + 1
    images = []
    for i, (eye, m) in enumerate(zip(_eyes(n), maps)):
        name = f"img_{i:03d}.jpg"
        _save_map(os.path.join(root, "edge_DexiNed", f"img_{i:03d}.png"), m)
        R, T = _look_at(eye)
        images.append((int(ids[i]), _qvec(R), T, COLMAP_CAMERAS[i % 3][0], name))
    pts = np.random.default_rng(8).uniform(0.2, 0.8, size=(points, 3))
    rgb = np.random.default_rng(9).integers(0, 256, size=(points, 3))
    if binary:
        with open(os.path.join(base, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(COLMAP_CAMERAS)))
            for cid, model, params in COLMAP_CAMERAS:
                f.write(struct.pack("<iiQQ", cid, MODEL_IDS[model], W, H))
                f.write(struct.pack("<" + "d" * len(params), *params))
        with open(os.path.join(base, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", n))
            for iid, q, t, cid, name in images:
                f.write(struct.pack("<i4d3di", iid, *q, *t, cid) + name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddqddq", 1.0, 2.0, -1, 3.0, 4.0, 0))
        if points:
            with open(os.path.join(base, "points3D.bin"), "wb") as f:
                f.write(struct.pack("<Q", points))
                for k in range(points):
                    f.write(struct.pack("<Q3d3Bd", k + 1, *pts[k], *rgb[k], 0.5))
                    f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))
    else:
        with open(os.path.join(base, "cameras.txt"), "w") as f:
            f.write("# Camera list\n")
            for cid, model, params in COLMAP_CAMERAS:
                f.write(f"{cid} {model} {W} {H} " + " ".join(repr(p) for p in params) + "\n")
        with open(os.path.join(base, "images.txt"), "w") as f:
            f.write("# Image list\n")
            for iid, q, t, cid, name in images:
                f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t)) + f" {cid} {name}\n")
                f.write("1.0 2.0 -1 3.0 4.0 0\n")
        if points:
            with open(os.path.join(base, "points3D.txt"), "w") as f:
                for k in range(points):
                    f.write(f"{k + 1} " + " ".join(repr(float(v)) for v in pts[k])
                            + " " + " ".join(str(int(v)) for v in rgb[k]) + " 0.5 1 0\n")


LOADER_CASES = [  # (format, variant, resolution, invert_edges, eval)
    ("emap", "grid", -1, "auto", False),
    ("emap", "sfm", 2, "on", True),
    ("emap", "rgb", 37, "off", False),
    ("blender", "abc-nef", 1, "auto", True),  # dark on white: auto inverts
    ("blender", "plain", 2, "auto", False),
    ("colmap", "bin", -1, "auto", True),
    ("colmap", "bin-nopoints", 2, "on", False),
    ("colmap", "txt", 37, "off", True),
    ("colmap", "txt-nopoints", 8, "auto", True),  # dark on white
    ("colmap", "bin", 3, "auto", True),
]


def build_scene(tmp_path, fmt, variant):
    if fmt == "emap":
        root = str(tmp_path / "emap")
        write_emap(root, c=3 if variant == "rgb" else None, sfm=variant == "sfm")
    elif fmt == "blender":
        if variant == "abc-nef":
            root = str(tmp_path / "ABC-NEF" / "00000006")
            write_blender(root, str(tmp_path / "ABC-NEF_Edge" / "data" / "00000006"), dark=True)
            write_blender(root, root, seed=21)  # other maps at the fallback path, which loses
        else:
            root = str(tmp_path / "nerf" / "lego")
            write_blender(root, root)
    else:
        root = str(tmp_path / "colmap")
        write_colmap(root, binary=variant.startswith("bin"),
                     points=0 if variant.endswith("nopoints") else 24,
                     dark=variant == "txt-nopoints")
    return root


def assert_cameras_match(pcams, jcams):
    assert len(pcams) == len(jcams)
    for pc, jc in zip(pcams, jcams):
        assert (pc.height, pc.width, pc.tanfovx, pc.tanfovy) == (
            jc.height, jc.width, jc.tanfovx, jc.tanfovy)
        for k in ("world_to_cam", "full_proj", "cam_center"):
            p, j = getattr(pc, k), np.asarray(getattr(jc, k))
            assert p.dtype == torch.float32 and p.device.type == "cpu"
            err = np.abs(p.numpy().astype(np.float64) - j).max()
            assert err <= 1e-6 * np.abs(j).max(), (k, err)


@pytest.mark.parametrize("case", range(len(LOADER_CASES)))
def test_loaders_match_jax(tmp_path, case):
    fmt, variant, res, inv, ev = LOADER_CASES[case]
    root = build_scene(tmp_path, fmt, variant)
    kw = dict(source_path=root, resolution=res, invert_edges=inv, eval=ev)
    ref = jdata.load_scene(JModel(**kw))
    got = pdata.load_scene(ModelConfig(**kw), device="cpu")
    assert_cameras_match(got.train_cameras, ref.train_cameras)
    assert_cameras_match(got.test_cameras, ref.test_cameras)
    for gm, rm in ((got.train_edge_maps, ref.train_edge_maps),
                   (got.test_edge_maps, ref.test_edge_maps)):
        assert len(gm) == len(rm)
        for g, r in zip(gm, rm):
            assert g.dtype == r.dtype == np.float32 and np.array_equal(g, r)
    assert got.seed_points.dtype == ref.seed_points.dtype
    assert np.array_equal(got.seed_points, ref.seed_points)
    assert abs(got.cameras_extent - ref.cameras_extent) <= 1e-12
    n = len(got.train_cameras)
    # what the case is meant to exercise actually happened
    assert len(got.test_cameras) == (0 if not ev else 2 if fmt == "colmap" else n)
    if res == 37:
        assert got.train_cameras[0].width == 37
    # bright edges on dark after the polarity rule, unless forced to invert
    assert (np.mean([m.mean() for m in got.train_edge_maps]) > 0.5) == (inv == "on")


def test_colmap_readers_match_jax(tmp_path):
    for binary in (True, False):
        root = str(tmp_path / f"c{binary}")
        write_colmap(root, n=5, binary=binary)
        pc, pi, pp, prgb = pcolmap.load_sparse(root)
        jc, ji, jp, jrgb = jcolmap.load_sparse(root)
        assert pc.keys() == jc.keys() and pi.keys() == ji.keys()
        for k in jc:
            assert (pc[k].id, pc[k].model, pc[k].width, pc[k].height) == (
                jc[k].id, jc[k].model, jc[k].width, jc[k].height)
            assert np.array_equal(pc[k].params, jc[k].params)
        for k in ji:
            assert (pi[k].id, pi[k].camera_id, pi[k].name) == (ji[k].id, ji[k].camera_id,
                                                               ji[k].name)
            assert np.array_equal(pi[k].qvec, ji[k].qvec)
            assert np.array_equal(pi[k].tvec, ji[k].tvec)
            assert np.array_equal(pcolmap.qvec2rotmat(pi[k].qvec), jcolmap.qvec2rotmat(ji[k].qvec))
        assert np.array_equal(pp, jp) and np.array_equal(prgb, jrgb) and pp.shape == (24, 3)
    q = np.random.default_rng(0).normal(size=(6, 4))
    for v in q / np.linalg.norm(q, axis=1, keepdims=True):
        assert np.array_equal(pcolmap.qvec2rotmat(v), jcolmap.qvec2rotmat(v))


def test_read_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(11, 3)).astype(np.float32)
    cols = rng.uniform(size=(11, 3))
    nrm = rng.normal(size=(11, 3)).astype(np.float32)
    files = []
    for k, kw in enumerate((dict(), dict(colors=cols), dict(colors=cols, normals=nrm),
                            dict(colors=cols, ascii=True), dict(normals=nrm, ascii=True))):
        p = str(tmp_path / f"p{k}.ply")
        pply.write_ply(p, pts, **kw)
        files.append(p)
    p = str(tmp_path / "double.ply")  # other property types, colours in [0, 1]
    rec = np.empty(4, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("red", "<f4"),
                             ("green", "<f4"), ("blue", "<f4"), ("q", "<i4")])
    for name in rec.dtype.names:
        rec[name] = rng.uniform(size=4)
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
                b"property double x\nproperty double y\nproperty double z\n"
                b"property float red\nproperty float green\nproperty float blue\n"
                b"property int q\nend_header\n" + rec.tobytes())
    files.append(p)
    for p in files:
        got, ref = pply.read_ply(p), jply.read_ply(p)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (p, k)


# -- the scene maker ---------------------------------------------------------------

MAKER_ARGS = ["--size", "64", "--views", "3", "--curves", "2", "--lines", "1", "--seed", "3",
              "--dropout-frac", "0.3", "--dropout-radius", "2", "--double-edge", "0.6",
              "--double-shift", "3", "--salt", "0.01", "--edge-blur", "0.8"]


def test_scene_maker_matches_the_jax_script(tmp_path, monkeypatch):
    """The JAX script's own main() (its render routed to the JAX oracle, no
    interpret-mode kernel, and its persistent compile cache left off)
    against the port's maker (the plain K1 on the CPU), each pathology on:
    gt_edges.json equal, meta_data.json within 1e-6, the PNGs within one
    uint8 level (float32 render noise flips `astype(uint8)` only at level
    boundaries)."""
    import functools

    import jax
    from curve_gaussian_tpu.ops import render as jrender

    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo root
    spec = importlib.util.spec_from_file_location(
        "jax_make_ref_scale_scene", ROOT / "scripts" / "make_ref_scale_scene.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(jrender, "render", functools.partial(jrender.render,
                                                             backend="reference"))
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache" in k
                        else real_update(k, v))
    monkeypatch.setattr(sys, "argv", ["make_ref_scale_scene.py", "--out", jout] + MAKER_ARGS)
    script.main()
    res = make_ref_scale_scene(["--out", pout, "--device", "cpu"] + MAKER_ARGS, quiet=True)
    assert res["overflow"] == [0, 0, 0]

    for name in ("gt_edges.json", "meta_data.json"):
        with open(os.path.join(jout, name)) as f:
            ref = json.load(f)
        with open(os.path.join(pout, name)) as f:
            got = json.load(f)
        if name == "gt_edges.json":
            assert got == ref
            continue
        assert (got["height"], got["width"]) == (ref["height"], ref["width"]) == (64, 64)
        for g, r in zip(got["frames"], ref["frames"], strict=True):
            assert g["rgb_path"] == r["rgb_path"]
            for k in ("camtoworld", "intrinsics"):
                assert np.abs(np.array(g[k]) - np.array(r[k])).max() <= 1e-6
    diff, lit = 0, 0
    for sub in ("edge_DexiNed", "color"):
        for i in range(3):
            r = np.asarray(Image.open(os.path.join(jout, sub, f"{i:04d}.png"))).astype(int)
            g = read_png(os.path.join(pout, sub, f"{i:04d}.png")).astype(int)
            assert g.shape == r.shape == (64, 64) and np.abs(g - r).max() <= 1
            diff += int((g != r).sum())
            lit += int((r > 0).sum())
    assert lit > 500 and diff <= 0.02 * lit, (diff, lit)  # a few boundary flips at most


# -- the CLI on a dataset scene ---------------------------------------------------

def test_cli_trains_a_colmap_scene(tmp_path):
    """`--source-path` trains (no longer raises): a COLMAP scene with 24
    points3D as the seed cloud, its maps rendered from ground-truth curves,
    a few iterations on the CPU; parametric_edges.json and eval.json (from
    the scene's gt_edges.json) are written, with finite values."""
    from curve_gaussian_tpu_torch.data import synthetic
    from curve_gaussian_tpu_torch.ops import bezier
    from curve_gaussian_tpu_torch.ops.camera import make_camera
    from curve_gaussian_tpu_torch.ops.render import render

    cp, is_bez = synthetic.random_curves(np.random.default_rng(0), 3, 1)
    g = bezier.curve_gaussians(torch.as_tensor(cp), torch.full((4,), 0.01),
                               torch.as_tensor(is_bez), 24)
    maps = []
    for i, eye in enumerate(_eyes(6)):
        R, T = _look_at(eye)
        fx = COLMAP_CAMERAS[i % 3][2][0]
        fy = COLMAP_CAMERAS[i % 3][2][1 if i % 3 else 0]
        cam = make_camera(R.T, T, 2 * np.arctan(W / (2 * fx)), 2 * np.arctan(H / (2 * fy)), H, W,
                          device="cpu")
        with torch.no_grad():
            img = render(g["xyz"].reshape(-1, 3), g["scale"].reshape(-1, 3),
                         g["quat"].reshape(-1, 4), torch.full((96,), 0.95), cam, bg=0.0,
                         render_geo=False, compute_invdepth=False)["render"]
        maps.append((img.numpy().clip(0, 1) * 255).astype(np.uint8))
    root = str(tmp_path / "scene")
    write_colmap(root, n=6, maps=maps)
    with open(os.path.join(root, "gt_edges.json"), "w") as f:
        json.dump({"curves_ctl_pts": cp[is_bez].reshape(-1, 12).tolist(),
                   "lines_end_pts": cp[~is_bez][:, [0, 3], :].reshape(-1, 6).tolist()}, f)
    out = str(tmp_path / "run")
    res = ptrain_cli.main(["-s", root, "-m", out, "--device", "cpu", "--iterations", "8",
                           "--test-iterations", "8", "--eval", "--quiet", "--n-gaussians", "6"])
    assert int(res.ts.step) == 8
    with open(os.path.join(out, "parametric_edges.json")) as f:
        edges = json.load(f)
    assert len(edges["curves_ctl_pts"]) + len(edges["lines_end_pts"]) > 0
    with open(os.path.join(out, "eval.json")) as f:
        ev = json.load(f)
    assert {"chamfer", "fscore_0.01"} <= ev.keys()
    assert all(np.isfinite(v) for v in ev.values()), ev
