"""The binning kernels (``csrc/binning.cu`` through ``ops/binning_cuda.py``)
against the plain PyTorch version, ``bin_gaussians_plain``, on the same
inputs.

The first two tests run here: on CPU tensors ``bin_gaussians`` is the
plain version, bitwise, and never loads the library; and the routing keeps
float64 fields, the exact key (``packed=False``) and the ``pairs`` method
on the plain version whatever the device, while float32 fields binned by
the packed sort on a card take the kernels.  The others need a CUDA card
(``pytest --noconftest -m cuda tests/test_torch_port_binning_cuda.py``):
every field of ``Binning``, the slots table included, bitwise equal to the
plain version on the card over cases that overflow the per-tile capacity,
the rect and the big tier, a band keyed by its image's tile count, a tile
of more candidates than the kernels sort at once, P not a multiple of the
block size, an empty view (every Gaussian behind the
camera) and a view of padding alone; three launches bitwise equal; one
CUDA graph replayed over changed inputs; and a training chunk's captured
step launching each kernel once.

The kernels round the alpha cull as PyTorch's CUDA kernels round the plain
version's elementwise operations (``csrc/binning.cu`` says how), so every
output is held bitwise.  One of those roundings is PyTorch's and not
IEEE division's: a float32 tensor divided by a Python number is multiplied
by the number's reciprocal rounded to float32.  A cull that differs by an
ulp of ln(255 opa) moves a candidate only at the edge of its support, which
random scenes seldom reach, so a test holds that rounding directly; under
another PyTorch a failure there is the library's new arithmetic, and the
kernel's has to follow it.
"""
import math

import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch import _build
from curve_gaussian_tpu_torch.ops import binning as pbin
from curve_gaussian_tpu_torch.ops import binning_cuda as pbc
from curve_gaussian_tpu_torch.ops import camera as pcam
from curve_gaussian_tpu_torch.ops import projection as pp

# name: (H, W, scene kwargs, bin kwargs); the first three are
# test_torch_port_binning.py's cases
CASES = {
    "plain": (96, 128, dict(P=400), dict(capacity=256, big_capacity=64)),
    "overflow": (160, 224, dict(P=500, crowd=120, big=12, huge=3),
                 dict(capacity=48, big_capacity=5, max_rect=16)),
    "odd_size": (100, 150, dict(P=300, big=4), dict(capacity=1100, big_capacity=2048)),
    "wide": (512, 512, dict(P=6001, crowd=400, big=300, huge=20),
             dict(capacity=128, big_capacity=256)),
    "band": (96, 512, dict(P=2000, big=40), dict(capacity=96, big_capacity=64, key_tiles=400)),
    # a tile of more candidates than the kernels sort at once (csrc/binning.cu: CHUNK)
    "deep": (64, 64, dict(P=9000, crowd=5000), dict(capacity=4500, big_capacity=64)),
    "empty": (64, 96, dict(P=130, behind=True), dict(capacity=32, big_capacity=16)),
    "padding": (64, 96, dict(P=129, dead=True), dict(capacity=32, big_capacity=16)),
}


def _scene(seed, P, crowd=0, big=0, huge=0, behind=False, dead=False):
    """Random Gaussians in view: rows 0-5 behind the camera (all with
    `behind`), `crowd` piled on one tile, `big` wide enough for the big
    tier, `huge` wider than max_rect tiles; one in twenty padding, or all
    with `dead`."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.7, 0.7, size=(P, 3))
    xyz[: P if behind else 6, 2] = -2.5
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
    alive = np.zeros(P, bool) if dead else rng.uniform(size=P) > 0.05
    return [xyz, scale, q, opa], alive


def _pre(case: str, device, dtype=torch.float32, seed=None) -> pp.Preprocessed:
    """The case's Gaussians projected by ``preprocess`` (the projection
    kernel on a card); a band case shifts them up by its first row, as
    ``parallel/sharding.py::_band_inputs`` does."""
    H, W, sk, _ = CASES[case]
    arrays, alive = _scene(sorted(CASES).index(case) if seed is None else seed, **sk)
    full_h = 256 if case == "band" else H
    cam = pcam.look_at_camera([0.1, 0.2, -1.8], [0, 0, 0], fovx=math.radians(60.0),
                              height=full_h, width=W, device=device)
    ins = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    with torch.no_grad():
        pre = pp.preprocess(*ins, cam, alive=torch.tensor(alive, device=device))
    if case == "band":
        pre = pre._replace(mean2d=pre.mean2d - torch.tensor([0.0, 64.0], device=device))
    return pp.Preprocessed(*(t.to(dtype) if t.is_floating_point() else t for t in pre))


def _bin(fn, pre, case, slots):
    H, W, _, bk = CASES[case]
    return fn(pre, H, W, slots=slots, **bk)


def _assert_equal(got, ref, what=""):
    for name in pbin.Binning._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, (what, name)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.dtype, b.dtype,
                                                            a.shape, b.shape)
        bad = a != b
        assert not bool(bad.any()), (what, name, int(bad.sum()), a[bad][:5].tolist(),
                                     b[bad][:5].tolist())


def _launches():
    return pbc.bin_tiles.launches


@pytest.mark.parametrize("slots", [False, True])
def test_bin_gaussians_on_cpu_is_the_plain_version(slots):
    before = _launches()
    for case in ("overflow", "band", "empty"):
        pre = _pre(case, "cpu")
        _assert_equal(_bin(pbin.bin_gaussians, pre, case, slots),
                      _bin(pbin.bin_gaussians_plain, pre, case, slots), case)
    assert _launches() == before == 0
    assert "binning" not in _build._libs


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA tensor, to drive the routing here."""

    @property
    def is_cuda(self):
        return True


class _Routed(Exception):
    pass


def test_routing_keeps_float64_exact_key_and_pairs_plain(monkeypatch):
    """On a card's float32 fields the packed sort takes the kernels; float64
    fields, ``packed=False`` and ``method="pairs"`` keep the plain version."""

    def kernels(*args, **kwargs):
        raise _Routed

    monkeypatch.setattr(pbc, "bin_tiles", kernels)
    case = "overflow"
    for dtype, kw in ((torch.float32, {}), (torch.float64, {}),
                      (torch.float32, dict(packed=False)), (torch.float32, dict(method="pairs"))):
        pre = _pre(case, "cpu", dtype)
        card = pp.Preprocessed(*(t.as_subclass(_OnCard) for t in pre))
        assert card.mean2d.is_cuda and pbc.takes(card) == (dtype == torch.float32)
        if dtype == torch.float32 and not kw:
            with pytest.raises(_Routed):
                _bin(lambda *a, **k: pbin.bin_gaussians(*a, **k, **kw), card, case, True)
            continue
        got = _bin(lambda *a, **k: pbin.bin_gaussians(*a, **k, **kw), card, case, True)
        ref = _bin(lambda *a, **k: pbin.bin_gaussians_plain(*a, **k, **kw), pre, case, True)
        _assert_equal(got, ref, (dtype, kw))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binning kernels have no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_on_card(case, slots):
    """Every field, bitwise, against ``bin_gaussians_plain`` on the same
    CUDA tensors; the kernels launched once."""
    _card()
    pre = _pre(case, "cuda")
    before = _launches()
    got = _bin(pbin.bin_gaussians, pre, case, slots)
    assert _launches() == before + 1
    ref = _bin(pbin.bin_gaussians_plain, pre, case, slots)
    torch.cuda.synchronize()
    _assert_equal(got, ref, case)
    H, W, sk, bk = CASES[case]
    if case in ("overflow", "deep"):
        assert int(ref.peak) > bk["capacity"], "the crowded tile must exceed K"
    if case == "deep":
        assert int(ref.peak) > 4096, "the crowded tile must exceed a sorted chunk"
    if case == "overflow":
        assert int(ref.big_count) > bk["big_capacity"] and int(ref.big_overflow) > 0
        assert int(ref.overflow) > int(ref.big_overflow), "K and rect overflow count too"
    if case in ("empty", "padding"):
        assert int(ref.counts.sum()) == 0
    else:
        assert int(ref.counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide", "deep"])
def test_kernels_bitwise_from_launch_to_launch(case):
    """Three launches on the same inputs give the same bits, though the
    buckets fill in another order each time."""
    _card()
    pre = _pre(case, "cuda", seed=11)
    runs = [_bin(pbin.bin_gaussians, pre, case, True) for _ in range(3)]
    for r in runs[1:]:
        _assert_equal(r, runs[0], "launch to launch")


@pytest.mark.cuda
def test_graph_replays_follow_changed_inputs():
    """One CUDA graph of ``bin_gaussians`` on fixed input buffers: after new
    Gaussians are copied into them, each replay equals the plain version on
    those Gaussians; the capture counts one launch of the kernels."""
    _card()
    case = "wide"
    pres = [_pre(case, "cuda", seed=s) for s in (21, 22)]
    bufs = pp.Preprocessed(*(t.clone() for t in pres[0]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bin(pbin.bin_gaussians, bufs, case, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches()
    with torch.cuda.graph(graph):
        out = _bin(pbin.bin_gaussians, bufs, case, True)
    assert _launches() == before + 1
    replays = []
    for pre in (pres[1], pres[0], pres[1]):
        for b, t in zip(bufs, pre):
            b.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        replays.append(pbin.Binning(*(None if t is None else t.clone() for t in out)))
        _assert_equal(replays[-1], _bin(pbin.bin_gaussians_plain, pre, case, True), "replay")
    assert not torch.equal(replays[0].gather_idx, replays[1].gather_idx)


@pytest.mark.cuda
def test_training_chunk_launches_each_kernel_once_a_step():
    """The captured training step holds one launch of the binning kernels;
    the chunk's steps replay it."""
    _card()
    from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
    from curve_gaussian_tpu_torch.data import synthetic as psyn
    from curve_gaussian_tpu_torch.engine import train as ptrain
    from curve_gaussian_tpu_torch.models import curve_state as pcs

    rng = np.random.default_rng(0)
    views = psyn.ring_cameras(3, 32, 32, device="cuda")
    gts = torch.tensor(rng.uniform(size=(3, 32, 32)) ** 4, dtype=torch.float32, device="cuda")
    ts = ptrain.init_train_state(pcs.init_state(rng.uniform(0.3, 0.7, size=(40, 3)), n_views=3,
                                                n_gaussians=4, device="cuda"))
    stacks = tuple(torch.stack([getattr(c, f) for c in views])
                   for f in ("world_to_cam", "full_proj", "cam_center"))
    graphs = ptrain.StepGraphs()
    before = _launches()
    ptrain.train_steps_scan(ts, stacks, gts, 0.0, OptimizationConfig(),
                            PipelineConfig(tile_capacity=128, big_capacity=64), use_mask=False,
                            n_gaussians=4, cam_geom=(32, 32, views[0].tanfovx, views[0].tanfovy),
                            rows=[2, 0, 1, 1], graphs=graphs)
    (cap,) = graphs.captures
    assert cap["launches"]["bin_tiles"] == 1
    assert cap["replays"] == 4
    assert _launches() - before == graphs.warmup_steps + 1


@pytest.mark.cuda
def test_division_by_a_number_is_the_kernels_product_on_card():
    """``clamp(opa, min=1e-12) / ALPHA_EPS`` and the tile divisions of the
    plain version, on the card, are the products by the reciprocals that
    ``csrc/binning.cu`` takes, bit for bit; and not IEEE division."""
    _card()
    from curve_gaussian_tpu_torch.ops.rasterize_ref import ALPHA_EPS, TILE_W

    g = torch.Generator(device="cuda").manual_seed(0)
    o = torch.clamp(torch.rand(1 << 20, device="cuda", generator=g) ** 3, min=1e-12)
    inv = torch.tensor(1.0 / ALPHA_EPS, dtype=torch.float32, device="cuda")
    assert torch.equal(o / ALPHA_EPS, o * inv)
    ieee = o / torch.tensor(ALPHA_EPS, dtype=torch.float32, device="cuda")
    assert not torch.equal(o / ALPHA_EPS, ieee)
    x = (torch.rand(1 << 20, device="cuda", generator=g) - 0.5) * 4096
    assert torch.equal(x / TILE_W, x * torch.tensor(1.0 / TILE_W, device="cuda"))
