"""Tile binning on the card: the ``sort`` method with the packed key in the
five kernels of ``csrc/binning.cu``, one launch of ``bin_tiles``.

One thread per Gaussian writes the packed keys of its tier-1 rect slots
with the exact alpha cull; one thread per Gaussian or big-tier column
places each big Gaussian in index order, writes the keys of its big-tier
slots and counts every candidate into its tile; one block scans the
counts into tile starts and sums the telemetry; one thread per pair puts
each candidate's key into its tile's bucket; one block per tile sorts its
bucket in shared memory and writes its row of the [T, K] table and its
candidates' slots.  The result equals ``binning.bin_gaussians_plain``'s
bit for bit, the slots table's (tile, slot) order included
(``csrc/binning.cu`` says how), in place of the plain version's ~340
small kernels a view.

``bin_gaussians`` takes this for CUDA float32 inputs binned by the sort
method with the packed key (``takes``); every other input keeps the plain
version.  Nothing synchronises with the host, so the launch is captured
in the training step's graph and the render graphs.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .projection import Preprocessed
from .rasterize_ref import ALPHA_EPS, TILE_H, TILE_W

NT = 128  # threads of the per-Gaussian kernels (csrc/binning.cu: NT)
_FLOATS = ("mean2d", "conic", "depth", "opacity", "extent")

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    """The binning kernels' library, ``csrc/binning.cu``."""
    lib = _build.load("binning")
    if not getattr(lib, "_typed", False):
        lib.bin_tiles.argtypes = ([_VP] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 6
                                  + [_VP] * 8)
        lib.bin_tiles.restype = _I
        lib._typed = True
    return lib


def takes(pre: Preprocessed) -> bool:
    """Whether the kernels bin `pre`: CUDA tensors with float32 fields."""
    return pre.mean2d.is_cuda and all(getattr(pre, f).dtype == torch.float32 for f in _FLOATS)


def _check_inputs(pre: Preprocessed) -> None:
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    for name, shape in (("mean2d", (P, 2)), ("conic", (P, 3)), ("depth", (P,)),
                        ("opacity", (P,)), ("extent", (P, 2)), ("valid", (P,))):
        t = getattr(pre, name)
        dtype = torch.bool if name == "valid" else torch.float32
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _blocks(n: int) -> int:
    return -(-n // NT)


def bin_tiles(pre: Preprocessed, nty: int, ntx: int, capacity: int, max_rect: int,
              tier1_rect: int, big_capacity: int, tbits: int, slots: bool) -> tuple:
    """``Binning``'s fields from the kernels, for inputs that ``takes``;
    `tbits` is the packed key's tile bits."""
    _check_inputs(pre)
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    T = nty * ntx
    R = max(tier1_rect, max_rect)  # the slots table's rows
    rbits = (R - 1).bit_length()  # the key's bits for a pair's rect slot
    n = tier1_rect * P + max(max_rect - tier1_rect, 0) * big_capacity
    if P >= 2 ** (31 - rbits) or n >= 2**31 or T * capacity >= 2**31:
        raise ValueError(f"the binning kernels take fewer than 2^{31 - rbits} Gaussians and "
                         f"index pairs and table entries in 32 bits: {P} Gaussians, {n} pairs, "
                         f"{T} x {capacity} entries")
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.empty(2 * n, dtype=torch.int64, device=dev)  # the keys, then the buckets
    ints = torch.empty(3 * T + 1 + 2 * max(_blocks(P), 1) + _blocks(max(P, big_capacity)), **i32)
    gather = torch.empty((T, capacity), **i32)
    slot_valid = torch.empty((T, capacity), dtype=torch.bool, device=dev)
    counts = torch.empty(T, **i32)
    slot_table = torch.empty((R, P), **i32) if slots else None
    out = torch.empty(4, **i32)
    lib = _lib()
    code = lib.bin_tiles(
        *(getattr(pre, f).data_ptr() for f in (*_FLOATS, "valid")), P, ntx, nty, TILE_W, TILE_H,
        1.0 / ALPHA_EPS, max_rect, tier1_rect, big_capacity, capacity, tbits, rbits,
        keys.data_ptr(), ints.data_ptr(), gather.data_ptr(), slot_valid.data_ptr(),
        counts.data_ptr(), None if slot_table is None else slot_table.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "bin_tiles")
    bin_tiles.launches += 1
    return (gather, slot_valid, counts, *out.unbind(), slot_table)


bin_tiles.launches = 0
