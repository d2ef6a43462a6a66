"""The roofline counts on hand-counted cases."""
from __future__ import annotations

import pytest
import torch

import bench_tiny  # noqa: F401  (the repository on the path)
from benchmark import counts as K


def one_gaussian(opacity: float = 0.5, sigma2: float = 4.0):
    """One isotropic Gaussian at pixel (16, 16) of a 32 x 32 image: its
    field row and the sentinel's, one tile listing it once."""
    f = torch.tensor([[16.0, 16.0, 1.0 / sigma2, 0.0, 1.0 / sigma2, opacity],
                      [0.0] * 6])
    return f, torch.tensor([[0]], dtype=torch.int32), torch.tensor([1], dtype=torch.int32)


def test_pairs_of_one_gaussian():
    # alpha = 0.5 exp(-r^2 / 8) >= 1/255 where r^2 <= 8 ln 127.5 = 38.78: the
    # 121 pixels with dx^2 + dy^2 <= 38; T = 1 - alpha >= 0.5 passes, so all
    # of them contribute; every pixel of the tile is a live pair
    pairs = K.pair_counts(*one_gaussian(), 32, 32)
    assert pairs == dict(live=1024, cand=121, contrib=121, inst=1)


def test_partial_tile_and_stopped_pixel():
    # four sharp Gaussians of alpha 0.95 on pixel (3, 3): T falls to 0.05,
    # 0.0025, 1.25e-4, and the fourth's test (6.25e-6 < 1e-4) stops the
    # pixel, so it is a candidate but no contribution; rows 16-31 of the
    # tile lie outside a 32 x 16 image, so each slot has 512 live pairs
    f = torch.tensor([[3.0, 3.0, 100.0, 0.0, 100.0, 0.95]] * 4 + [[0.0] * 6])
    pairs = K.pair_counts(f, torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
                          torch.tensor([4], dtype=torch.int32), 16, 32)
    assert pairs == dict(live=4 * 512, cand=4, contrib=3, inst=3)


def test_blend_bounds_by_hand():
    pairs = dict(live=1024, cand=121, contrib=121, inst=1)
    s = K.blend_train_seconds(P=1, n_inst=1, tiles=1, H=32, W=32, pairs=pairs)
    # K1: field rows 8 x 32 B, one list entry, one count, bg, two images out
    assert s["blend_train_fwd"] == pytest.approx((256 + 4 + 4 + 4 + 2 * 32 * 32 * 4) / 3.35e12)
    # K2: field rows in, entry, count, four images in, moment rows out
    assert s["blend_train_bwd"] == pytest.approx((256 + 4 + 4 + 4 * 4096 + 256) / 3.35e12)
    # the reduction: one slot row, the 16-row slots table of one Gaussian, the rows out
    assert s["reduce_slots"] == pytest.approx((32 + 16 * 4 + 256) / 3.35e12)


def test_operation_bound_takes_over():
    # a million candidate and contributing pairs: 25 + 3 operations each
    # outweigh K1's 8 KB, and 25 + 22 K2's
    pairs = dict(live=10 ** 6, cand=10 ** 6, contrib=10 ** 6, inst=10)
    s = K.blend_train_seconds(P=1, n_inst=1, tiles=1, H=32, W=32, pairs=pairs)
    assert K.GATE_OPS == 25 and K.MOMENT_OPS == 23
    assert s["blend_train_fwd"] == pytest.approx(28e6 / 67e12)
    assert s["blend_train_bwd"] == pytest.approx(48e6 / 67e12)


def test_ssim_bounds_by_hand():
    s = K.ssim_seconds(800, 800)
    assert s["ssim_fwd"] == pytest.approx(640000 * 239 / 67e12)  # 2.28 us, operations
    assert s["ssim_bwd"] == pytest.approx(640000 * 437 / 67e12)  # 4.17 us, operations
