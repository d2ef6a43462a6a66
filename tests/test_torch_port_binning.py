"""Parity of the port's tile binning with ``curve_gaussian_tpu/ops/binning.py``
(method 'sort'): the [T, K] tables and every telemetry counter must be
EQUAL, under the exact (tile, depth, index) key and under the packed
[tile | depth bits] key, including scenes that overflow the per-tile
capacity, the per-Gaussian rect and the big tier.

Both binnings take the same preprocessed Gaussians (the JAX preprocess,
handed to the port as numpy), so the comparison isolates the binning.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from curve_gaussian_tpu.ops import binning as jbin
from curve_gaussian_tpu.ops import projection as jproj

from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import rasterize_ref as pref
from test_torch_port_geometry import cam_pair, jax_x64, tt

FIELDS = ("gather_idx", "slot_valid", "counts", "overflow", "peak", "big_count", "big_overflow")


@pytest.fixture(scope="module", autouse=True)
def _x64():
    with jax_x64():
        yield


def _scene(seed, P, dtype, crowd=0, big=0, huge=0):
    """Random Gaussians in view; `crowd` of them piled on one tile, `big`
    wide enough for the big tier, `huge` wider than max_rect tiles."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.7, 0.7, size=(P, 3))
    xyz[:6, 2] = -2.5  # behind the camera: culled
    scale = np.stack([rng.uniform(0.01, 0.06, P), rng.uniform(0.002, 0.01, P),
                      rng.uniform(0.002, 0.01, P)], -1)
    c0 = 6
    xyz[c0 : c0 + crowd] = [0.05, 0.05, 0.0] + rng.normal(0, 0.003, size=(crowd, 3))
    b0 = c0 + crowd
    scale[b0 : b0 + big] = rng.uniform(0.08, 0.15, size=(big, 3))
    h0 = b0 + big
    scale[h0 : h0 + huge] = rng.uniform(0.4, 0.6, size=(huge, 3))
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opa = rng.uniform(0.05, 0.95, P)
    alive = rng.uniform(size=P) > 0.05
    return [a.astype(dtype) for a in (xyz, scale, q, opa)] + [alive]


def _pre_pair(inputs, H, W, dtype):
    xyz, scale, q, opa, alive = inputs
    jc, _ = cam_pair([0.1, 0.2, -1.8], [0, 0, 0], H, W, dtype)
    jpre = jproj.preprocess(*(jnp.asarray(a) for a in (xyz, scale, q, opa)), jc,
                            alive=jnp.asarray(alive))
    ppre = pproj.Preprocessed(*(tt(a, None) for a in jpre))
    return jpre, ppre


def _bin_both(jpre, ppre, H, W, packed, **kw):
    jb = jbin.bin_gaussians(jpre, H, W, packed=packed, **kw)
    pb = pbin.bin_gaussians(ppre, H, W, packed=packed, **kw)
    return jb, pb


def _assert_equal(jb, pb):
    for f in FIELDS:
        a = getattr(pb, f).numpy()
        b = np.asarray(getattr(jb, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)


CASES = {
    # name: (H, W, scene kwargs, bin kwargs)
    "plain": (96, 128, dict(P=400), dict(capacity=256, big_capacity=64)),
    "overflow": (160, 224, dict(P=500, crowd=120, big=12, huge=3),
                 dict(capacity=48, big_capacity=5, max_rect=16)),
    "odd_size": (100, 150, dict(P=300, big=4), dict(capacity=1100, big_capacity=2048)),
}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_and_telemetry_equal(case, packed):
    H, W, sk, bk = CASES[case]
    jpre, ppre = _pre_pair(_scene(sorted(CASES).index(case), dtype=np.float32, **sk), H, W, np.float32)
    jb, pb = _bin_both(jpre, ppre, H, W, packed, **bk)
    _assert_equal(jb, pb)
    assert int(pb.counts.sum()) > 0
    if case == "overflow":
        assert int(pb.peak) > bk["capacity"], "the crowded tile must exceed K"
        assert int(pb.big_count) > bk["big_capacity"] and int(pb.big_overflow) > 0
        assert int(pb.overflow) > int(pb.big_overflow), "K and rect overflow count too"


def test_exact_sort_float64():
    """Under x64 the exact key compares float64 depths; the port sorts by
    depth then tile (stable) since a float64 depth does not fit beside the
    tile in one int64 key."""
    H, W, sk, bk = CASES["overflow"]
    jpre, ppre = _pre_pair(_scene(7, dtype=np.float64, **sk), H, W, np.float64)
    jb, pb = _bin_both(jpre, ppre, H, W, False, **bk)
    _assert_equal(jb, pb)


def test_membership_and_module_flag():
    """membership() agrees with the table, and packed=None reads the
    module's SORT_PACKED flag (True by default, as in the JAX package)."""
    H, W, sk, bk = CASES["plain"]
    jpre, ppre = _pre_pair(_scene(3, dtype=np.float32, **sk), H, W, np.float32)
    assert pbin.SORT_PACKED is True and jbin.SORT_PACKED is True
    _assert_equal(jbin.bin_gaussians(jpre, H, W, **bk), pbin.bin_gaussians(ppre, H, W, **bk))
    pb = pbin.bin_gaussians(ppre, H, W, **bk)
    mem = pref.membership(pb, ppre.mean2d.shape[0])
    assert mem.shape == (ppre.mean2d.shape[0], pb.gather_idx.shape[0])
    assert int(mem.sum()) == int(pb.counts.sum())
    with pytest.raises(ValueError):
        pbin.bin_gaussians(ppre, H, W, method="grid")  # 'sort' and 'pairs' only
    assert not ppre.mean2d.requires_grad and pb.gather_idx.dtype == torch.int32
