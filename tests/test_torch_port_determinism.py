"""The fixed-order backward's bookkeeping on the CPU, with no JAX: the
per-Gaussian slot order the binning hands the slot -> Gaussian reduction
(``Binning.slots``), and that reduction's plain version.

- ``Binning.slots`` against a numpy construction from ``gather_idx``
  (``test_torch_port_cull_cases.slots_table``): every listed slot exactly
  once, under its Gaussian, in (tile, slot) order, with pairs past the
  capacity K and past the big tier's capacity dropped, for both binning
  methods and both sort keys;
- ``reduce_slots`` (its plain version on the CPU) against ``index_add_`` in
  float64, within 1e-12 of max, for the 8- and 16-column rows of K2/K5/K6b
  and K4, launching nothing;
- the table is built only for a render whose backward reads it, and a
  differentiable blend refuses, at the call, fields that need a gradient
  without it.

K2's plain backward in this layout against the JAX kernel is in
``test_torch_port_blend.py`` (its interpret-mode reference is built there
once); the kernels' bitwise repeats need the card
(``test_torch_port_isolation.py::test_backward_kernels_repeat_bitwise``).
"""
import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops import projection as pproj
from curve_gaussian_tpu_torch.ops import rasterize_cuda as prc
from curve_gaussian_tpu_torch.ops import render as prender
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as ptb
from curve_gaussian_tpu_torch.ops.camera import look_at_camera
from test_torch_port_cull_cases import slots_table

H, W = 160, 224


def _preprocessed(seed=0, P=500, crowd=120, big=12, huge=3):
    """A view of random Gaussians: `crowd` piled on one tile (past K),
    `big` in the big tier (past its capacity below), `huge` wider than
    max_rect tiles, a few behind the camera and some not alive."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.7, 0.7, size=(P, 3))
    xyz[:6, 2] = -2.5
    scale = np.stack([rng.uniform(0.01, 0.06, P), rng.uniform(0.002, 0.01, P),
                      rng.uniform(0.002, 0.01, P)], -1)
    xyz[6:6 + crowd] = [0.05, 0.05, 0.0] + rng.normal(0, 0.003, size=(crowd, 3))
    b0 = 6 + crowd
    scale[b0:b0 + big] = rng.uniform(0.08, 0.15, size=(big, 3))
    scale[b0 + big:b0 + big + huge] = rng.uniform(0.4, 0.6, size=(huge, 3))
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opa = rng.uniform(0.05, 0.95, P)
    alive = torch.tensor(rng.uniform(size=P) > 0.05)
    cam = look_at_camera(eye=np.array([0.1, 0.2, -1.8]), target=np.zeros(3), height=H, width=W,
                         dtype=torch.float64, device="cpu")
    return pproj.preprocess(*(torch.tensor(a) for a in (xyz, scale, q, opa)), cam, alive=alive)


@pytest.mark.parametrize("method,packed", [("sort", True), ("sort", False), ("pairs", True)])
def test_slot_order_from_the_binning(method, packed):
    pre = _preprocessed()
    P = pre.mean2d.shape[0]
    b = pbin.bin_gaussians(pre, H, W, capacity=64, big_capacity=8, method=method, packed=packed,
                           slots=True)
    if method == "sort":
        assert int(b.big_overflow) > 0, "the scene must overflow the big tier"
    assert int(b.peak) > 64, "the scene must overflow the capacity K"
    slots = b.slots.numpy()
    assert b.slots.dtype == torch.int32 and slots.shape[1] == P
    want = slots_table(b.gather_idx, b.counts, P)
    listed = int(b.counts.sum())
    assert int((slots >= 0).sum()) == listed == int((want >= 0).sum())
    for p in range(P):
        got = slots[:, p][slots[:, p] >= 0]
        assert np.array_equal(got, want[:, p][want[:, p] >= 0]), p
    # the rows name the Gaussian's own slots of the table
    flat = b.gather_idx.reshape(-1).numpy()
    cols = np.broadcast_to(np.arange(P), slots.shape)
    assert np.array_equal(flat[slots[slots >= 0]], cols[slots >= 0])


@pytest.mark.parametrize("nf", [8, 16])
def test_plain_reduction_against_index_add(nf):
    pre = _preprocessed(seed=1)
    b = pbin.bin_gaussians(pre, H, W, capacity=64, big_capacity=8, slots=True)
    P = pre.mean2d.shape[0]
    P1 = -(-(P + 1) // 8) * 8
    rng = np.random.default_rng(2)
    rows = torch.tensor(rng.normal(size=tuple(b.gather_idx.shape) + (nf,)))
    # empty slots hold the sentinel P; their rows are zeros, as the kernels write them
    rows[b.gather_idx == P] = 0.0
    n = prc.reduce_slots.launches
    got = prc.reduce_slots(rows, b.slots, P1)
    want = prc._reduce_rows(torch.zeros((P1, nf), dtype=torch.float64), b.gather_idx, rows)
    assert prc.reduce_slots.launches == n  # the plain version on the CPU
    assert got.shape == (P1, nf) and bool((got[P:] == 0).all())
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert float(want.abs().max()) > 0


def test_slots_only_where_a_backward_reads_them(monkeypatch):
    pre = _preprocessed(seed=3)
    b = pbin.bin_gaussians(pre, H, W, capacity=64, big_capacity=8)
    bs = pbin.bin_gaussians(pre, H, W, capacity=64, big_capacity=8, slots=True)
    assert b.slots is None and bs.slots is not None
    assert all(torch.equal(x, y) for x, y in zip(b[:-1], bs[:-1]))

    fields = prc.stack_fields(pre).requires_grad_(True)
    bg = torch.zeros(1, dtype=fields.dtype)
    with pytest.raises(ValueError, match="slots table"):
        prc.blend_train(fields, b.gather_idx, b.counts, None, bg, H, W)
    f4 = prc.stack_fields(pre, torch.ones_like(pre.opacity), torch.zeros_like(pre.mean2d[:, :1])
                          .expand(-1, 4), geo=True, invd=True, ones=True).requires_grad_(True)
    with pytest.raises(ValueError, match="slots table"):
        ptb.tile_blend(f4, b.gather_idx, b.counts, None, bg, H, W, True, True, True)
    with torch.no_grad():  # a forward alone needs no table
        prc.blend_train(fields, b.gather_idx, b.counts, None, bg, H, W)

    asked = []

    def binning(*args, **kw):
        asked.append(kw["slots"])
        return pbin.bin_gaussians(*args, **kw)

    monkeypatch.setattr(prender, "bin_gaussians", binning)
    rng = np.random.default_rng(4)
    xyz, scale = torch.tensor(rng.uniform(-0.3, 0.3, (40, 3))), torch.full((40, 3), 0.02)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).double().expand(40, 4)
    opa = torch.full((40,), 0.5, dtype=torch.float64).requires_grad_(True)
    cam = look_at_camera(eye=np.array([0.0, 0.0, -1.5]), target=np.zeros(3), height=64,
                         width=64, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        prender.render(xyz, scale.double(), q, opa, cam, capacity=64, big_capacity=8)
    out = prender.render(xyz, scale.double(), q, opa, cam, render_geo=False,
                         compute_invdepth=False, capacity=64, big_capacity=8)
    out["render"].sum().backward()
    assert asked == [False, True] and float(opa.grad.abs().max()) > 0
