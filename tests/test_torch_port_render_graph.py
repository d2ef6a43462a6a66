"""``engine/train.py::eval_renders`` and the renders that replay through its
body (``render_views``) on CPU tensors, the eager form of what the card
captures as one CUDA graph per key and replays once per view:

(a) ``eval_renders`` of 3 views of a 48x48 state equals ``eval_render`` of
    each view bitwise (the render stack and the full maps of the views
    named), with ``render_geo`` on and off and with the mask;
(b) the same body against the JAX ``eval_render`` of each view
    (``backend="reference"`` on both sides, float64, the exact depth sort),
    within ``tests/test_torch_port_render.py``'s float64 tolerance;
(c) the key: a state's capacity or the tile capacity makes a new key,
    whose lookup drops the held renders; the same key finds its render;
(d) a tiny ``train_scene`` whose test views have two image sizes: its
    ``test_l1`` and ``test_psnr`` rows equal, bitwise, the values
    recomputed from ``eval_render`` of each view of the returned state, and
    its debug images are byte for byte those of the eager maps;
(e) ``render_curves``: every frame's SHA-256 equals that of an eager
    ``render`` of its camera.

The CUDA graphs themselves are exercised by ``chip_smoke.py`` on the card.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import synthetic as psyn
from curve_gaussian_tpu_torch.engine import loop as ploop
from curve_gaussian_tpu_torch.engine import train as ptrain
from curve_gaussian_tpu_torch.models import curve_state as pcs
from curve_gaussian_tpu_torch.scripts import render_curves as prc

H = W = 48
M = 4
PIPE = PipelineConfig(tile_capacity=128, big_capacity=64)
VIEWS = [2, 0, 1]  # stack rows, out of order


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread leaves the cores to the suite's
    other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _scene(dtype=torch.float32, n_curves=30, capacity=None):
    rng = np.random.default_rng(0)
    cams = psyn.ring_cameras(3, H, W, dtype=dtype, device="cpu")
    pts = rng.uniform(0.3, 0.7, size=(n_curves, 3))
    ts = ptrain.init_train_state(pcs.init_state(pts, n_views=3, n_gaussians=M, dtype=dtype,
                                                capacity=capacity, device="cpu"))
    # a spread of mask logits, so that the hard mask gates some Gaussians off
    ts.params["mask_raw"] = torch.tensor(rng.normal(1.0, 3.0, size=ts.params["mask_raw"].shape),
                                         dtype=dtype)
    return cams, ts


def _geom(cams):
    return (cams[0].height, cams[0].width, cams[0].tanfovx, cams[0].tanfovy)


@pytest.mark.parametrize("render_geo,use_mask", [(True, False), (False, False), (True, True)])
def test_eval_renders_equal_eval_render(render_geo, use_mask):
    """(a): the stack and every map bitwise, view by view."""
    cams, ts = _scene()
    pipe = PipelineConfig(tile_capacity=128, big_capacity=64, render_geo=render_geo)
    stacks = ptrain.camera_stacks(cams, torch.float32, "cpu")
    stack, maps = ptrain.eval_renders(ts, stacks, _geom(cams), pipe, 0.25, VIEWS,
                                      use_mask=use_mask, mask_threshold=0.3, full=[0, 1])
    assert stack.shape == (len(VIEWS), H, W) and sorted(maps) == [0, 1]
    for i, v in enumerate(VIEWS):
        with torch.no_grad():
            ref = ptrain.eval_render(ts, cams[v], pipe, 0.25, use_mask=use_mask,
                                     mask_threshold=0.3)
        assert torch.equal(stack[i], ref["render"]), v
        for k in ptrain.EVAL_MAPS:
            if v in maps:
                assert torch.equal(maps[v][k], ref[k]), (v, k)
    assert float(stack.max()) > 0.5
    if not render_geo:
        assert float(maps[0]["dir"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="outside views"):
        ptrain.eval_renders(ts, stacks, _geom(cams), pipe, 0.0, [0], full=[1])


def test_eval_renders_against_jax():
    """(b): float64 on both sides, the JAX oracle's render of each view."""
    import jax.numpy as jnp

    from curve_gaussian_tpu.config import PipelineConfig as JPipe
    from curve_gaussian_tpu.engine import train as jtrain
    from test_torch_port_geometry import cam_pair, exact_sort, jax_state, jax_x64, state_arrays
    from test_torch_port_render import F64_TOL, OUTS
    from test_torch_port_step import _numpy_ts

    C = 8
    params, is_bez, alive = state_arrays(np.random.default_rng(0), C, M, n_dead=1)
    params["mask_raw"][2, :3] = -7.0  # gated off by the hard mask
    eyes = ([0.0, 0.2, -1.8], [0.9, 0.1, -1.5], [-0.7, -0.3, -1.6])
    with jax_x64(), exact_sort():
        pairs = [cam_pair(e, [0, 0, 0], H, W) for e in eyes]
        jts = jtrain.init_train_state(jax_state(params, is_bez, alive))
        jpipe = JPipe(tile_capacity=PIPE.tile_capacity, backend="reference")
        refs = [jtrain.eval_render(jts, jc, jpipe, jnp.asarray(0.0), use_mask=True,
                                   n_gaussians=M) for jc, _ in pairs]
        s = _numpy_ts(jts)
        ts = convert.train_state_from_numpy(
            s["params"], s["mu"], s["nu"], s["count"], s["is_bezier"], s["alive"],
            s["xyz_grad_accum"], s["denom"], s["max_radii"], s["step"], s["opacity_frozen"],
            device="cpu", dtype=torch.float64)
        cams = [pc for _, pc in pairs]
        stack, maps = ptrain.eval_renders(
            ts, ptrain.camera_stacks(cams, torch.float64, "cpu"), _geom(cams),
            PipelineConfig(tile_capacity=PIPE.tile_capacity, backend="reference"), 0.0, VIEWS,
            use_mask=True, full=VIEWS)
    for i, v in enumerate(VIEWS):
        assert stack.dtype == torch.float64
        for k in OUTS:
            port = stack[i] if k == "render" else maps[v][k]
            ref = np.asarray(refs[v][k])
            err = np.abs(port.numpy() - ref).max() / np.abs(ref).max()
            assert err <= F64_TOL, (v, k, err)
        assert float(stack[i].max()) > 0.5


def test_render_key_follows_the_sizes():
    """(c): new capacities make a new key, whose lookup drops the held
    render and pool; the same key finds its render; another geometry is a
    key beside it."""
    cams, ts = _scene(capacity=64)
    _, ts_big = _scene(capacity=128)
    stacks = ptrain.camera_stacks(cams, torch.float32, "cpu")
    geom = _geom(cams)

    def key(t, pipe=PIPE, n=3, g=geom, st=stacks):
        return ptrain.eval_render_key(t, st, g, pipe, 0.0, n)

    k = key(ts)
    assert k == key(ts)
    graphs = ptrain.RenderGraphs()
    held = object()
    graphs._held[k] = held
    assert graphs._lookup(key(ts)) is held
    # another view group (image size, stacks) of the same sizes: held beside
    small = psyn.ring_cameras(2, 32, 40, device="cpu")
    k_small = key(ts, n=2, g=_geom(small), st=ptrain.camera_stacks(small, torch.float32, "cpu"))
    assert k_small[0] == k[0] and k_small != k
    graphs._held[k_small] = held
    assert graphs._lookup(k_small) is held and len(graphs._held) == 2
    for other in (key(ts_big), key(ts, PipelineConfig(tile_capacity=256, big_capacity=64)),
                  ptrain.eval_render_key(ts, stacks, geom, PIPE, 0.0, 3, use_mask=True)):
        assert other != k
        graphs._held[k] = held
        graphs._pool = "pool"
        assert graphs._lookup(other) is None
        assert graphs._held == {} and graphs._pool is None


def _run(tmp_path):
    """A tiny train_scene whose test views come in two image sizes."""
    scene = psyn.make_scene(seed=1, n_curves=3, n_lines=1, n_views=6, height=H, width=W,
                            capacity=64, device="cpu")
    other = psyn.make_scene(seed=2, n_curves=3, n_lines=1, n_views=2, height=32, width=40,
                            capacity=64, device="cpu")
    test_cams = [scene.cameras[0], other.cameras[0], scene.cameras[3], other.cameras[1],
                 scene.cameras[5], scene.cameras[1]]
    test_maps = [scene.edge_maps[0], other.edge_maps[0], scene.edge_maps[3], other.edge_maps[1],
                 scene.edge_maps[5], scene.edge_maps[1]]
    seeds = scene.curves.mean(axis=1).astype(np.float32)
    opt = OptimizationConfig(iterations=4, densify_from_iter=2, densify_until_iter=100,
                             densification_interval=2)
    res = ploop.train_scene(
        scene.cameras, [e.numpy() for e in scene.edge_maps], seeds, ModelConfig(n_gaussians=M),
        opt, PipelineConfig(tile_capacity=128), str(tmp_path / "run"), test_cameras=test_cams,
        test_edge_maps=[e.numpy() for e in test_maps], test_iterations=(4,), quiet=True,
        scan_chunk=2, device="cpu")
    return res, test_cams, test_maps


def test_train_scene_test_metrics_bitwise(tmp_path):
    """(d): metrics.jsonl's test row and the debug images, against the
    eager render of each test view from the returned state."""
    res, cams, maps = _run(tmp_path)
    with open(res.metrics_path) as fh:
        rows = [json.loads(line) for line in fh if "test_l1" in line]
    assert [r["iter"] for r in rows] == [4]
    l1s, psnrs = [], []
    eager_dir = str(tmp_path / "eager")
    for ti, (cam, gt) in enumerate(zip(cams, maps)):
        with torch.no_grad():
            out = ptrain.eval_render(res.ts, cam, res.pipe_cfg, 0.0,
                                     mask_threshold=OptimizationConfig().mask_threshold)
        img, tg = out["render"].cpu().numpy(), gt.numpy()
        l1s.append(float(np.abs(img - tg).mean()))
        psnrs.append(-10.0 * np.log10(float(np.mean((img - tg) ** 2)) + 1e-12))
        if ti < 5:
            ploop.save_debug_images(out, tg, eager_dir, 4, ti)
    assert rows[0]["test_l1"] == float(np.mean(l1s))
    assert rows[0]["test_psnr"] == float(np.mean(psnrs))
    got_dir = os.path.join(res.model_path, "test_images", "iter_000004")
    want_dir = os.path.join(eager_dir, "test_images", "iter_000004")
    names = sorted(os.listdir(want_dir))
    assert len(names) == 25 and sorted(os.listdir(got_dir)) == names
    for n in names:
        with open(os.path.join(got_dir, n), "rb") as a, open(os.path.join(want_dir, n), "rb") as b:
            assert a.read() == b.read(), n
    assert res.render_graphs is not None and res.render_graphs.captures == []


def test_render_curves_frames_equal_eager(tmp_path):
    """(e): each frame's SHA-256 against an eager render of its camera."""
    cp, is_b = psyn.random_curves(np.random.default_rng(4), 3, 1)
    edges = str(tmp_path / "edges.json")
    with open(edges, "w") as f:
        json.dump({"curves_ctl_pts": cp[is_b].reshape(-1, 12).tolist(),
                   "lines_end_pts": cp[~is_b][:, [0, 3]].reshape(-1, 6).tolist()}, f)
    argv = ["--edges", edges, "--out", str(tmp_path / "curves"), "--size", "48", "--n-orbit",
            "3", "--device", "cpu"]
    res = prc.render_curves(argv, quiet=True)
    args = prc.parse_args(argv)
    xyz, scale, quat, opa = prc.edge_gaussians(json.load(open(edges)), args.width, "cpu")
    gauss = {"xyz": xyz, "scale": scale, "quat": quat, "opacity": opa}
    cams = prc.video_cameras(args, "cpu")
    assert len(res["sha256"]) == len(cams) == 3
    for i, cam in enumerate(cams):
        with torch.no_grad():
            img = prc.frame_render(gauss, cam).numpy()
        assert hashlib.sha256(prc.frame_u8(img).tobytes()).hexdigest() == res["sha256"][i], i
        if i == 0:
            assert np.array_equal(img, res["first_frame"]) and img.max() > 0.05
