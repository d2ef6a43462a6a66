"""8-bit PNG reading and writing, and Pillow's bicubic resize, with numpy
and the standard library alone (``zlib``, ``struct``).

The JAX package's loaders read edge maps through PIL
(``np.asarray(Image.open(p))``, then ``Image.resize`` for ``-r``).  The port
does not depend on PIL: ``read_png`` returns the same uint8 array for the
8-bit greyscale, grey + alpha, RGB and RGBA files edge detectors write, and
``resize_bicubic_u8`` reproduces Pillow's default resize filter for 8-bit
images (``libImaging/Resample.c``) bit for bit.

Palette, 16-bit, sub-8-bit and interlaced files raise: for them
``np.asarray(Image.open(p)) / 255`` gives palette indices or values outside
[0, 1], so no edge map the JAX loader reads correctly is refused.  A resize
of an image whose alpha is not all 255 raises too: Pillow premultiplies the
alpha there, which this module does not mirror.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale [H, W] or RGB [H, W, 3] uint8 image as a PNG
    (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced greyscale, grey + alpha, RGB
    or RGBA PNG as uint8: [H, W] for greyscale, else [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {color}, interlace "
            f"{interlace}; only 8-bit non-interlaced greyscale, grey + alpha, RGB and "
            "RGBA files are read (no palette, 16-bit, sub-8-bit or interlaced files)")
    bpp = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError(f"{path}: truncated image data")
    raw = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    filters, rows = raw[:, 0], raw[:, 1:].reshape(h, w, bpp)
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    out = _unfilter_sweep(filters, rows) if (filters >= 3).any() else _unfilter_rows(filters, rows)
    return out[..., 0] if bpp == 1 else out


def _unfilter_rows(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Rows filtered with None (0), Sub (1) and Up (2) only: each a vector
    operation along its row (Sub is a cumulative sum mod 256 per byte
    lane)."""
    out = np.empty_like(rows)
    prev = np.zeros_like(rows[0])
    for y, ft in enumerate(filters):
        r = rows[y]
        if ft == 0:
            out[y] = r
        elif ft == 1:
            out[y] = np.cumsum(r, axis=0, dtype=np.uint8)
        else:
            out[y] = r + prev
        prev = out[y]
    return out


def _unfilter_sweep(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Any mix of the five filters.  Average (3) and Paeth (4) need the
    pixel to the left, so the image is undone one anti-diagonal y + x = d at
    a time: a pixel's left (a), upper (b) and upper-left (c) neighbours lie
    on the two diagonals before it.  The image is stored skewed,
    S[y + 1, y + x + 1] = out[y, x], so that each diagonal is a column of S
    and its neighbours are slices of the two columns before it; the zero
    row and the entries never written (column -1 among them) stand for the
    pixels outside the image."""
    h, w, bpp = rows.shape
    ys = np.arange(h)[:, None]
    cols = ys + np.arange(w)[None, :] + 1
    R = np.zeros((h, h + w + 1, bpp), np.int16)
    R[ys, cols] = rows
    S = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    ft = filters.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a, b, c = S[lo + 1:hi + 1, d], S[lo:hi, d], S[lo:hi, d - 1]
        f = ft[lo:hi]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(f == 3, (a + b) >> 1,
                                                                   np.where(f == 4, paeth, 0))))
        S[lo + 1:hi + 1, d + 1] = (R[lo:hi, d + 1] + pred) & 0xFF
    return S[ys + 1, cols].astype(np.uint8)


PRECISION_BITS = 32 - 8 - 2  # libImaging/Resample.c


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter, a = -0.5, in its operation order."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the whole
    axis: (first input index [out], int64 fixed-point weights [out, ksize])."""
    scale = in_size / out_size  # (in1 - in0) / outSize; the box is exact in float
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    x = np.arange(ksize)
    k = _bicubic(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    k = np.where(x[None, :] < xmax[:, None], k, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # the C loop's summation order
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    kf = k * (1 << PRECISION_BITS)
    fixed = np.where(k < 0, np.trunc(-0.5 + kf), np.trunc(0.5 + kf)).astype(np.int64)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (0 rows, 1 columns) of a uint8 [H, W, C] image:
    each output's taps gathered and weighted, summed from Resample.c's start
    value 1 << 21, then shifted and clipped to uint8 as its 8-bit passes
    do (the integer sums are exact, so their order does not matter)."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], in_size - 1)
    shape = [1, 1, 1]
    shape[axis] = out_size
    ss = np.full((), 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):  # one gathered tap of every output at a time
        ss = ss + np.take(img, idx[:, j], axis=axis).astype(np.int64) * k[:, j].reshape(shape)
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height))`` for a uint8 [H, W]
    or [H, W, C] image: Pillow's BICUBIC, the horizontal pass first, each
    pass rounded and clipped to uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bicubic_u8 takes uint8 images, not {img.dtype}")
    if img.shape[:2] == (height, width):
        return img.copy()
    if img.ndim == 3 and img.shape[2] in (2, 4) and (img[..., -1] != 255).any():
        raise ValueError("resize of an image with alpha below 255: Pillow premultiplies "
                         "the alpha there, which resize_bicubic_u8 does not mirror")
    x = img[..., None] if img.ndim == 2 else img
    if width != x.shape[1]:
        x = _resample_axis(x, width, 1)
    if height != x.shape[0]:
        x = _resample_axis(x, height, 0)
    return x[..., 0] if img.ndim == 2 else x
