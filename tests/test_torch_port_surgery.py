"""Parity of the port's topology surgery with ``curve_gaussian_tpu``'s:
every host edit applied to one seeded set of curves through both packages
gives equal arrays (the same numpy arithmetic: exactly), the schedule fires
at the same iterations, and ``apply_schedule`` at an iteration of each event
kind gives the same training state on both sides.

Surgery decides by thresholds, where the smallest difference would change
the topology, so each test checks that none of the values it decides on
lies within 1e-4 (relative) of its threshold, instead of trusting a seed.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curve_gaussian_tpu.config import OptimizationConfig as JOpt
from curve_gaussian_tpu.engine import optim as joptim
from curve_gaussian_tpu.engine import train as jtrain
from curve_gaussian_tpu.models import surgery as jsurg

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.config import OptimizationConfig
from curve_gaussian_tpu_torch.models import fitting
from curve_gaussian_tpu_torch.models import surgery as psurg

N, M = 26, 8
MARGIN = 1e-4


def clear_of(values, threshold, what):
    """No value within MARGIN (relative) of the threshold."""
    v = np.asarray(values, np.float64).reshape(-1)
    gap = np.abs(v - threshold).min() if v.size else np.inf
    assert gap > MARGIN * abs(threshold), f"{what}: a value lies {gap:.3g} from {threshold}"


def _seeded_curves():
    """numpy HostCurves fields with something for every edit to do."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0.2, 0.8, size=(N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    half = rng.uniform(0.05, 0.12, size=(N, 1))
    cp = np.stack([base - d * half, base - d * half / 3, base + d * half / 3, base + d * half], 1)
    cp += rng.normal(0, 0.02, size=cp.shape) * np.array([0, 1, 1, 0])[None, :, None]
    cp[0:3, 1] += 0.08  # strongly bent: curvature split
    cp[0:3, 2] -= 0.05
    # curves 3 and 4 continue each other along x: a Bézier merge
    cp[3] = [[0.10, 0.5, 0.5], [0.15, 0.5, 0.5], [0.20, 0.5, 0.5], [0.25, 0.5, 0.5]]
    cp[4] = [[0.255, 0.5, 0.5], [0.30, 0.5, 0.5], [0.35, 0.5, 0.5], [0.40, 0.5, 0.5]]
    cp[3:5, 1:3, 1] += np.array([[0.0004, -0.0003], [0.0003, -0.0004]])  # near-straight
    # curve 5: near-straight and alone, becomes a line
    cp[5] = [[0.6, 0.2, 0.3], [0.65, 0.2004, 0.3], [0.7, 0.1997, 0.3], [0.75, 0.2, 0.3]]
    # curves 6-8: collinear line segments along z, joined end to end
    for i, z in zip(range(6, 9), (0.1, 0.22, 0.34)):
        cp[i] = [[0.8, 0.8, z], [0.8, 0.8, z + 0.04], [0.8, 0.8, z + 0.08], [0.8, 0.8, z + 0.11]]
    is_bez = np.ones(N, bool)
    is_bez[6:9] = False
    is_bez[20:22] = False
    cp[9] = cp[9, :1] + np.linspace(0, 1, 4)[:, None] * 1e-3  # tiny
    opa = rng.uniform(0.3, 0.9, N)
    opa[10:12] = [0.004, 0.03]  # below opacity_cull / opacity_cull_second
    mask = rng.normal(3.0, 1.0, size=(N, M))
    mask[12] = -8.0  # mask-dead
    mask[13, :3] = -7.0  # trimmed at the start
    mask[14, -2:] = -7.5  # trimmed at the end
    grad = rng.uniform(0, 1500, size=(N, M))
    grad[15:18, 3] = [2600.0, 3100.0, 2450.0]  # densify splits
    denom = np.ones((N, M))
    params = {
        "curve_points": cp.astype(np.float32),
        "opacity_raw": np.log(opa / (1 - opa)).astype(np.float32),
        "width_raw": np.log(rng.uniform(0.003, 0.01, N)).astype(np.float32),
        "mask_raw": mask.astype(np.float32),
        "features_dc": np.zeros((N, M, 1), np.float32),
    }
    mu = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    nu = {k: rng.uniform(size=v.shape).astype(np.float32) for k, v in params.items()}
    return dict(params=params, mu=mu, nu=nu, is_bezier=is_bez,
                grad_accum=(grad * denom).astype(np.float32), denom=denom.astype(np.float32),
                max_radii=rng.integers(0, 9, size=(N, M)).astype(np.int32))


def _hosts():
    f = _seeded_curves()
    return jsurg.HostCurves(**copy.deepcopy(f)), psurg.HostCurves(**copy.deepcopy(f))


def assert_same_host(j, p):
    assert p.n == j.n
    for group in ("params", "mu", "nu"):
        for k, v in getattr(j, group).items():
            w = getattr(p, group)[k]
            assert w.dtype == v.dtype and np.array_equal(w, v), f"{group}/{k}"
    for k in ("is_bezier", "grad_accum", "denom", "max_radii"):
        assert np.array_equal(getattr(p, k), getattr(j, k)), k


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


OPT = OptimizationConfig()


def _margins(op, h):
    """Check the values `op` decides on are clear of their thresholds."""
    cp, bez = h.params["curve_points"], h.is_bezier
    if op in ("densify_and_prune", "only_prune", "keep"):
        clear_of(_sig(h.params["opacity_raw"]), OPT.opacity_cull, "opacity")
        clear_of(_sig(h.params["opacity_raw"]), OPT.opacity_cull_second, "opacity 2")
    if op == "densify_and_prune":
        clear_of((h.grad_accum / h.denom).max(axis=1), OPT.densify_grad_threshold, "grad")
    if op in ("only_prune", "mask_trim_split"):
        clear_of(_sig(h.params["mask_raw"]), OPT.mask_threshold, "mask")
    if op == "only_prune":
        t = psurg.sample_t_mid(M)
        p = psurg.np_curve_points(cp, t, bez)
        pb = psurg.np_curve_points(cp, t - 0.5 / M, bez)
        clear_of(np.linalg.norm(p - pb, axis=-1).sum(axis=1), 1e-2, "length")
    if op == "curve_split_curvature":
        tan = psurg.np_tangent(cp, psurg.sample_t_mid(M), bez)
        tan = tan / (np.linalg.norm(tan, axis=-1, keepdims=True) + 1e-12)
        for s, thr in ((1, OPT.threshold_angle), (2, OPT.threshold_angle_skip)):
            cos = np.clip(np.einsum("nmc,nmc->nm", tan[:, :-s], tan[:, s:]), -1, 1)
            clear_of(np.arccos(cos).max(axis=1), np.deg2rad(thr), f"angle {s}")
    if op == "fit_curve_to_line":
        pts = psurg.np_curve_points(cp, np.linspace(0.0, 1.0, 100), bez)
        means, maxes = [], []
        for i in np.where(bez)[0]:
            start, end, direction, mean, tmin, tmax = fitting.fit_line_pca(pts[i])
            proj = np.clip((pts[i] - mean) @ direction, tmin, tmax)
            d = np.linalg.norm(pts[i] - (mean + proj[:, None] * direction), axis=1)
            means.append(d.mean())
            maxes.append(d.max())
        clear_of(means, OPT.threshold_line, "line mean")
        clear_of(maxes, OPT.threshold_max_line, "line max")
    if op == "merge_curves":
        ends = np.concatenate([cp[:, 0], cp[:, 3]])
        tan = np.concatenate([cp[:, 1] - cp[:, 0], cp[:, 2] - cp[:, 3]])
        tan = tan / (np.linalg.norm(tan, axis=1, keepdims=True) + 1e-6)
        clear_of(np.linalg.norm(ends[:, None] - ends[None], axis=-1),
                 2 * OPT.distance_threshold, "endpoint distance")
        clear_of(np.abs(tan @ tan.T), OPT.similarity_threshold, "tangent similarity")
        segs = cp[~bez][:, [0, 3], :].reshape(-1, 6)
        clear_of(fitting.pairwise_segment_distances(segs), OPT.distance_threshold, "segment d")
        clear_of(np.abs(fitting.pairwise_cosine_similarity(segs)), OPT.similarity_threshold,
                 "segment cos")


EDITS = {
    "densify_and_prune": lambda s, h: s.densify_and_prune(h, OPT.densify_grad_threshold,
                                                         OPT.opacity_cull),
    "curve_split_curvature": lambda s, h: s.curve_split_curvature(h, OPT.threshold_angle,
                                                                 OPT.threshold_angle_skip),
    "only_prune": lambda s, h: s.only_prune(h, OPT.opacity_cull, OPT.mask_threshold),
    "mask_trim_split": lambda s, h: s.mask_trim_split(h, OPT.mask_threshold),
    "fit_curve_to_line": lambda s, h: s.fit_curve_to_line(h, OPT.threshold_line,
                                                         OPT.threshold_max_line),
    "merge_curves": lambda s, h: s.merge_curves(h, OPT.distance_threshold,
                                               OPT.similarity_threshold, seed=10000),
    "fix_opacity_host": lambda s, h: s.fix_opacity_host(h),
    "keep": lambda s, h: s.keep(h, _sig(h.params["opacity_raw"]) > OPT.opacity_cull_second),
    "split_curves": lambda s, h: s.split_curves(h, np.arange(N) % 5 == 1,
                                               np.linspace(0.2, 0.8, N)[np.arange(N) % 5 == 1]),
    "append": lambda s, h: s.append(
        h, {k: v[:3] * 1.5 for k, v in h.params.items()}, np.array([True, False, True])),
}


@pytest.mark.parametrize("op", sorted(EDITS))
def test_host_edit_matches_jax(op):
    jh, ph = _hosts()
    _margins(op, ph)
    before = copy.deepcopy(ph)
    jout = EDITS[op](jsurg, jh)
    pout = EDITS[op](psurg, ph)
    assert_same_host(jout, pout)
    changed = pout.n != before.n or any(
        not np.array_equal(pout.params[k], before.params[k]) for k in psurg.PARAM_KEYS)
    assert changed, f"{op} did nothing to the seeded curves"


def test_de_casteljau_split_and_trim_match_jax():
    f = _seeded_curves()
    cp, bez = f["params"]["curve_points"].astype(np.float64), f["is_bezier"]
    t = np.random.default_rng(1).uniform(0.1, 0.9, N)
    for a, b in zip(jsurg.np_de_casteljau_split(cp, t, bez), psurg.np_de_casteljau_split(cp, t, bez)):
        assert np.array_equal(a, b)
    assert np.array_equal(jsurg.np_trim(cp, t * 0.3, t, bez), psurg.np_trim(cp, t * 0.3, t, bez))


def _compressed(iterations=600):
    o = JOpt()
    s = iterations / o.iterations
    return dataclasses.replace(
        o, iterations=iterations, densify_from_iter=int(o.densify_from_iter * s),
        densify_until_iter=int(o.densify_until_iter * s), conn_from_iter=int(o.conn_from_iter * s),
        densification_interval=int(o.densification_interval * s),
        prune_trim_interval=int(o.prune_trim_interval * s), split_interval=int(o.split_interval * s),
        split_from_iter=int(o.split_from_iter * s), merge_interval=int(o.merge_interval * s))


@pytest.mark.parametrize("compressed", [False, True])
def test_schedule_fires_matches_jax(compressed):
    jopt = _compressed() if compressed else JOpt()
    popt = OptimizationConfig(**dataclasses.asdict(jopt))
    fired = [i for i in range(1, 10_001) if jsurg.schedule_fires(i, jopt)]
    assert fired == [i for i in range(1, 10_001) if psurg.schedule_fires(i, popt)]
    assert len(fired) > 5


CAP = 256


def _padded(f):
    """The seeded curves padded to capacity CAP, as TrainState leaves."""
    def pad(x):
        out = np.zeros((CAP,) + x.shape[1:], x.dtype)
        out[:N] = x
        return out

    def group(d, expo):
        g = {k: pad(v) for k, v in d.items()}
        g["exposure"] = expo
        return g

    rng = np.random.default_rng(3)
    return dict(
        params=group(f["params"], np.tile(np.float32([1.1, 0.02]), (3, 1))),
        mu=group(f["mu"], rng.normal(size=(3, 2)).astype(np.float32)),
        nu=group(f["nu"], rng.uniform(size=(3, 2)).astype(np.float32)),
        count=17, is_bezier=pad(f["is_bezier"]), alive=np.arange(CAP) < N,
        xyz_grad_accum=pad(f["grad_accum"]).reshape(-1),
        denom=pad(f["denom"]).reshape(-1), max_radii=pad(f["max_radii"]).reshape(-1),
        step=41, opacity_frozen=False,
    )


def _jax_ts(a):
    cast = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return jtrain.TrainState(
        params=cast(a["params"]),
        opt=joptim.AdamState(mu=cast(a["mu"]), nu=cast(a["nu"]),
                             count=jnp.asarray(a["count"], jnp.int32)),
        is_bezier=jnp.asarray(a["is_bezier"]), alive=jnp.asarray(a["alive"]),
        xyz_grad_accum=jnp.asarray(a["xyz_grad_accum"]), denom=jnp.asarray(a["denom"]),
        max_radii=jnp.asarray(a["max_radii"]), step=jnp.asarray(a["step"], jnp.int32),
        opacity_frozen=jnp.asarray(a["opacity_frozen"]),
    )


# one iteration of each event kind under the default schedule
EVENTS = {"densify": 2000, "densify_until": 7000, "prune_trim": 7500, "split": 5000,
          "merge": 10000}


@pytest.mark.parametrize("kind", sorted(EVENTS))
def test_apply_schedule_matches_jax(kind):
    it = EVENTS[kind]
    fired = psurg.fired_ops(it, OPT)
    assert fired[0] == kind, fired  # densify_until (7000) also splits
    a = _padded(_seeded_curves())
    h = psurg.HostCurves(**copy.deepcopy(_seeded_curves()))
    edits = {"densify": ["densify_and_prune"], "densify_until": ["keep"],
             "prune_trim": ["only_prune", "mask_trim_split"], "split": ["curve_split_curvature"],
             "merge": ["fit_curve_to_line", "merge_curves"]}
    for op in fired:  # each edit's margins on the curves it receives
        for edit in edits[op]:
            _margins(edit, h)
            h = EDITS[edit](psurg, h) if edit != "keep" else psurg.fix_opacity_host(
                EDITS["keep"](psurg, h))
    jts = jsurg.apply_schedule(_jax_ts(a), it, JOpt())
    pts = psurg.apply_schedule(convert.train_state_from_numpy(
        a["params"], a["mu"], a["nu"], a["count"], a["is_bezier"], a["alive"],
        a["xyz_grad_accum"], a["denom"], a["max_radii"], a["step"], a["opacity_frozen"],
        device="cpu"), it, OPT)
    assert pts.alive.shape[0] == jts.alive.shape[0]
    assert int(pts.alive.sum()) == int(jnp.sum(jts.alive)) != N
    for g in ("params", "mu", "nu"):
        for k, v in getattr(jts if g == "params" else jts.opt, g).items():
            w = (pts.params if g == "params" else getattr(pts.opt, g))[k]
            assert w.dtype == torch.float32 and np.array_equal(w.numpy(), np.asarray(v)), f"{g}/{k}"
    for k in ("is_bezier", "alive", "xyz_grad_accum", "denom", "max_radii"):
        assert np.array_equal(getattr(pts, k).numpy(), np.asarray(getattr(jts, k))), k
    assert (pts.step, pts.opt.count, pts.opacity_frozen) == (
        int(jts.step), int(jts.opt.count), bool(jts.opacity_frozen))
    assert pts.opacity_frozen == (kind == "densify_until")
