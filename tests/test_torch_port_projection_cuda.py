"""The projection kernels (``csrc/projection.cu``: ``project_fwd``, and
``project_bwd`` as the backward of ``preprocess`` on CUDA tensors) against
the plain PyTorch version, ``preprocess_plain``, on the same inputs.

The first test runs here: on CPU tensors ``preprocess`` is the plain
version, bitwise, and launches nothing.  The others need a CUDA card
(``pytest --noconftest -m cuda tests/test_torch_port_projection_cuda.py``):
the kernels against the plain version over inputs that reach every
branch, three launches bitwise equal, one CUDA graph replayed over the
camera rows of a device stack, and a training chunk's captured step
launching each kernel once.

Tolerances.  The forward kernel rounds every operation as the plain
version does on the H100, its float32 GEMMs and GEMVs included (cuBLAS's
orders of fused multiply-adds, measured with torch 2.11.0+cu128 and
cuBLAS 12.9.2 at 500 to 200,000 Gaussians), so every output is held
bitwise: a thin Gaussian's covariance, nearly singular before the +0.3
dilation, would carry one ulp of the view-space mean into ~1e-5 of its
conic.  Those orders are undocumented; under another cuBLAS a failure of
the bitwise check here may be the library's new order, not the kernel's
fault, and the kernel's order has to follow it.  The
backward sums in its own order, so each gradient is held within 1e-5 of
itself plus 1e-5 of its largest entry (on the card 2e-6 of the largest
entry at most).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch.ops import camera as pcam
from curve_gaussian_tpu_torch.ops import projection as pp

H, W = 48, 64
FOVX, FOVY = math.radians(50.0), math.radians(40.0)
INPUTS = ("mean3d", "scale", "quat", "opacity")
# the rows of the special cases in ``_inputs``
BEHIND = slice(0, 4)
CLAMPED = slice(4, 8)
FAINT = slice(8, 12)
TIES = slice(12, 16)
SINGULAR = 16


def _camera(kind: str, device, with_intrinsics: bool):
    """``ring``: a ring camera at a general rotation; ``axis``: the world
    axes, 2 units in front, so a mean (2 u, 2 v, 0) projects exactly to
    (u, v) = view-space (x / z, y / z)."""
    if kind == "ring":
        cam = pcam.look_at_camera([0.1, 0.2, -1.8], [0, 0, 0], fovx=FOVX, height=H, width=W,
                                  device=device)
    else:
        cam = pcam.make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), FOVX, FOVY, H, W,
                               device=device)
    if with_intrinsics:
        intr = pp.intrinsics(H, W, cam.tanfovx, cam.tanfovy)
        cam = dataclasses.replace(cam, intrinsics=torch.tensor(intr, dtype=torch.float32,
                                                               device=device))
    return cam


def _singular_scale(mod: float) -> float:
    """A long axis at which the ``axis`` camera's Gaussian at the origin,
    turned 45 degrees in the image plane with zero minor axes, has a
    negative determinant after the dilation (float32 cancellation, found
    by the plain version on the CPU: the same operations round alike on
    the card, and the view-space mean is exact at the origin)."""
    c = pcam.make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), FOVX, FOVY, H, W, device="cpu")
    q = torch.tensor([[math.cos(math.pi / 8), 0.0, 0.0, math.sin(math.pi / 8)]])
    for s0 in np.geomspace(1e3, 2e3, 400).astype(np.float32):
        cov = pp.ewa_cov2d_direct(torch.zeros(1, 3), torch.tensor([[s0, 0.0, 0.0]]), q, c, mod)
        cxx, cxy, cyy = cov[0, 0] + pp.H_VAR, cov[0, 1], cov[0, 2] + pp.H_VAR
        if bool(cxx * cyy - cxy * cxy < 0.0):
            return float(s0)
    raise AssertionError("no scale gives a negative determinant")


def _inputs(kind: str, mod: float, device, P: int = 2000, seed: int = 0):
    """(mean3d, scale, quat, opacity, alive, cotangents): random Gaussians
    around the origin with rows 0-3 behind both cameras' near plane, 4-7
    beyond the 1.3 tanfov clamp, 8-11 under 1/255 opacity; for the
    ``axis`` camera rows 12-15 exactly on the clamp (a tie) and row 16
    with a negative determinant; one row in ten padding.  The singular
    row gets zero cotangents, as the blend gives a Gaussian it never
    bins."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.6, 0.6, size=(P, 3))
    xyz[BEHIND, 2] = -2.2
    xyz[CLAMPED, 0] = rng.choice([-3.0, 3.0], 4)
    scale = np.stack([rng.uniform(0.01, 0.08, P), rng.uniform(0.002, 0.02, P),
                      rng.uniform(0.002, 0.02, P)], -1)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opa = rng.uniform(0.05, 0.95, P)
    opa[FAINT] = rng.uniform(1e-4, 3e-3, 4)
    alive = rng.uniform(size=P) > 0.1
    cot = [rng.normal(size=s) for s in ((P, 2), (P, 3), (P,), (P,))]
    if kind == "axis":
        limx, limy = (np.float32(pp.FRUSTUM_CLAMP * math.tan(f / 2.0)) for f in (FOVX, FOVY))
        xyz[TIES] = [[2 * limx, 0, 0], [-2 * limx, 0, 0], [0, 2 * limy, 0], [0, -2 * limy, 0]]
        xyz[SINGULAR] = 0.0
        scale[SINGULAR] = [_singular_scale(mod), 0.0, 0.0]
        q[SINGULAR] = [math.cos(math.pi / 8), 0.0, 0.0, math.sin(math.pi / 8)]
        for c in cot:
            c[SINGULAR] = 0.0
    f32 = dict(dtype=torch.float32, device=device)
    ins = [torch.tensor(a, **f32) for a in (xyz, scale, q, opa)]
    return ins, torch.tensor(alive, device=device), [torch.tensor(c, **f32) for c in cot]


def _run(fn, ins, alive, cot, cam, mod, aa):
    """fn's outputs and the gradients of sum(output * cotangent) over
    (mean2d, conic, depth, opacity) in the four inputs."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    pre = fn(*leaves, cam, scale_modifier=mod, antialiasing=aa, alive=alive)
    outs = (pre.mean2d, pre.conic, pre.depth, pre.opacity)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), leaves)
    return pp.Preprocessed(*(t.detach() for t in pre)), list(grads)


def test_preprocess_on_cpu_is_the_plain_version():
    cam = _camera("axis", "cpu", False)
    ins, alive, cot = _inputs("axis", 1.3, "cpu", P=300)
    before = (pp.project_fwd.launches, pp.project_bwd.launches)
    for aa in (False, True):
        pre, grads = _run(pp.preprocess, ins, alive, cot, cam, 1.3, aa)
        ref, ref_grads = _run(pp.preprocess_plain, ins, alive, cot, cam, 1.3, aa)
        for name in pp.Preprocessed._fields:
            assert torch.equal(getattr(pre, name), getattr(ref, name)), name
        for name, g, r in zip(INPUTS, grads, ref_grads):
            assert torch.equal(g, r), name
    assert (pp.project_fwd.launches, pp.project_bwd.launches) == before == (0, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the projection kernels have no CPU form")


def _assert_outputs_equal(pre, ref):
    for name in pp.Preprocessed._fields:
        a, b = getattr(pre, name), getattr(ref, name)
        bad = a != b
        assert not bool(bad.any()), (name, a[bad][:5].tolist(), b[bad][:5].tolist())


def _assert_grads_close(grads, ref_grads):
    for name, g, r in zip(INPUTS, grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()),
                                   msg=lambda m, n=name: f"d {n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,aa,mod,with_intr", [
    ("ring", False, 1.0, False),
    ("ring", True, 1.0, True),
    ("axis", False, 1.0, True),
    ("axis", True, 1.7, False),
])
def test_kernels_match_plain_on_card(kind, aa, mod, with_intr):
    """Every output (bitwise) and gradient against ``preprocess_plain`` on
    the same CUDA tensors; the special rows reach every branch of the
    kernels."""
    _card()
    cam = _camera(kind, "cuda", with_intr)
    ins, alive, cot = _inputs(kind, mod, "cuda")
    n_fwd, n_bwd = pp.project_fwd.launches, pp.project_bwd.launches
    pre, grads = _run(pp.preprocess, ins, alive, cot, cam, mod, aa)
    assert (pp.project_fwd.launches, pp.project_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    ref, ref_grads = _run(pp.preprocess_plain, ins, alive, cot, cam, mod, aa)
    _assert_outputs_equal(pre, ref)
    _assert_grads_close(grads, ref_grads)
    # the special rows did what they are there for
    assert not bool(ref.valid[BEHIND].any()) and bool((ref.depth[BEHIND] <= 0.2).all())
    assert bool((ref.extent[FAINT] == 0.0).all())
    assert not bool(alive.all()) and not bool(ref.valid[~alive].any())
    if kind == "axis":
        view = ins[0][TIES, :2] / 2.0
        limx, limy = (pp.FRUSTUM_CLAMP * t for t in (cam.tanfovx, cam.tanfovy))
        assert bool((view.abs() == torch.tensor([[limx, 0], [limx, 0], [0, limy], [0, limy]],
                                                device="cuda", dtype=torch.float32)).all())
        assert not bool(ref.valid[SINGULAR]) and bool(ref.conic[SINGULAR, 0] < 0.0)
        assert all(bool((g[SINGULAR] == 0.0).all()) for g in grads)


@pytest.mark.cuda
def test_kernels_bitwise_from_launch_to_launch():
    """Three launches of each kernel on the same inputs give the same bits."""
    _card()
    cam = _camera("ring", "cuda", True)
    ins, alive, cot = _inputs("ring", 1.0, "cuda", P=20000, seed=3)
    runs = [_run(pp.preprocess, ins, alive, cot, cam, 1.0, True) for _ in range(3)]
    for pre, grads in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(pre, runs[0][0]))
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


@pytest.mark.cuda
def test_graph_replays_each_camera_row():
    """One CUDA graph of the forward and its backward, the camera picked
    from device stacks by a device counter as the captured training step
    picks it: each replay gives its view's own result, bitwise the eager
    kernels' at that view, and the capture counts one launch of each."""
    _card()
    cams = [_camera("ring", "cuda", True), _camera("axis", "cuda", True)]
    stacks = [torch.stack([getattr(c, f) for c in cams])
              for f in ("world_to_cam", "full_proj", "cam_center", "intrinsics")]
    ins, alive, cot = _inputs("ring", 1.0, "cuda", seed=5)
    row = torch.zeros(1, dtype=torch.int64, device="cuda")

    def body():
        w2c, proj, ctr, intr = (s.index_select(0, row)[0] for s in stacks)
        cam = pcam.Camera(world_to_cam=w2c, full_proj=proj, cam_center=ctr, height=H, width=W,
                          tanfovx=cams[0].tanfovx, tanfovy=cams[0].tanfovy, intrinsics=intr)
        return _run(pp.preprocess, ins, alive, cot, cam, 1.0, False)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n_fwd, n_bwd = pp.project_fwd.launches, pp.project_bwd.launches
    with torch.cuda.graph(graph):
        pre, grads = body()
    assert (pp.project_fwd.launches, pp.project_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    replays = []
    for v in (1, 0):
        row.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        replays.append(([t.clone() for t in pre], [g.clone() for g in grads]))
        eager, eager_grads = _run(pp.preprocess, ins, alive, cot, cams[v], 1.0, False)
        assert all(torch.equal(a, b) for a, b in zip(replays[-1][0], eager))
        assert all(torch.equal(a, b) for a, b in zip(replays[-1][1], eager_grads))
    assert not torch.equal(replays[0][0][0], replays[1][0][0])


@pytest.mark.cuda
def test_training_chunk_launches_each_kernel_once_a_step():
    """The captured training step holds one forward and one backward
    launch of the projection kernels; the chunk's steps replay them."""
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
    n_fwd, n_bwd = pp.project_fwd.launches, pp.project_bwd.launches
    ptrain.train_steps_scan(ts, stacks, gts, 0.0, OptimizationConfig(),
                            PipelineConfig(tile_capacity=128, big_capacity=64), use_mask=False,
                            n_gaussians=4, cam_geom=(32, 32, views[0].tanfovx, views[0].tanfovy),
                            rows=[2, 0, 1, 1], graphs=graphs)
    (cap,) = graphs.captures
    assert cap["launches"]["project_fwd"] == cap["launches"]["project_bwd"] == 1
    assert cap["replays"] == 4
    eager = graphs.warmup_steps
    assert pp.project_fwd.launches - n_fwd == pp.project_bwd.launches - n_bwd == eager + 1
