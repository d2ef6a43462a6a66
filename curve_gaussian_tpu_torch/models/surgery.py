"""Topology surgery: split / prune / trim / merge / line conversion, as
``curve_gaussian_tpu/models/surgery.py``.

The edits run on the host in numpy at a coarse cadence (every few hundred
iterations), so their Python cost does not matter; the training state on
the device keeps a power-of-two capacity between them:

  TrainState (device, capacity C)  --extract-->  HostCurves (alive rows only)
      --surgery ops (numpy)-->  HostCurves'
      --repack-->  TrainState (capacity = power-of-two bucket of the new count)

``extract`` copies each tensor's alive rows to the host in one transfer;
``repack`` builds the new state on the old state's device, in its dtypes.
The numpy edits are the JAX package's, operation for operation, so both
packages make the same topology from the same host arrays.

Adam moments follow the reference: prune slices the mu/nu rows, append
zeroes them for new rows, and an edit that replaces a row zeroes only that
row's moments.  Densification statistics reset on append and are sliced on
prune.  The exposure rows, their moments, the Adam count and the step carry
over unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from ..config import OptimizationConfig
from ..engine.optim import AdamState
from ..engine.train import TrainState
from . import fitting
from .curve_state import MIN_CAPACITY, inverse_sigmoid_np, round_capacity

PARAM_KEYS = ("curve_points", "opacity_raw", "width_raw", "mask_raw", "features_dc")


@dataclasses.dataclass
class HostCurves:
    params: Dict[str, np.ndarray]  # alive rows only
    mu: Dict[str, np.ndarray]
    nu: Dict[str, np.ndarray]
    is_bezier: np.ndarray  # [n] bool
    grad_accum: np.ndarray  # [n, M]
    denom: np.ndarray  # [n, M]
    max_radii: np.ndarray  # [n, M]

    @property
    def n(self) -> int:
        return len(self.is_bezier)

    @property
    def m(self) -> int:
        return self.params["mask_raw"].shape[1]


def sample_t_mid(m: int) -> np.ndarray:
    return (np.arange(m) + 0.5) / m


def np_curve_points(cp: np.ndarray, t: np.ndarray, is_bezier: np.ndarray):
    """cp [n,4,3], t [k] -> [n,k,3] mixed Bézier/line evaluation."""
    bez = fitting.sample_bezier(cp, t)
    lin = (1 - t)[None, :, None] * cp[:, None, 0] + t[None, :, None] * cp[:, None, 3]
    return np.where(is_bezier[:, None, None], bez, lin)


def np_tangent(cp: np.ndarray, t: np.ndarray, is_bezier: np.ndarray):
    u = 1 - t
    d = (
        3 * (u**2)[None, :, None] * (cp[:, None, 1] - cp[:, None, 0])
        + 6 * (u * t)[None, :, None] * (cp[:, None, 2] - cp[:, None, 1])
        + 3 * (t**2)[None, :, None] * (cp[:, None, 3] - cp[:, None, 2])
    )
    lin = np.broadcast_to((cp[:, 3] - cp[:, 0])[:, None, :], d.shape)
    return np.where(is_bezier[:, None, None], d, lin)


def np_de_casteljau_split(cp: np.ndarray, t: np.ndarray, is_bezier: np.ndarray):
    """cp [n,4,3], t [n] -> (left, right) halves; a line splits into two
    lines with evenly spaced inner points."""
    t = t.reshape(-1, 1)
    c0, c1, c2, c3 = cp[:, 0], cp[:, 1], cp[:, 2], cp[:, 3]
    q0 = (1 - t) * c0 + t * c1
    q1 = (1 - t) * c1 + t * c2
    q2 = (1 - t) * c2 + t * c3
    r0 = (1 - t) * q0 + t * q1
    r1 = (1 - t) * q1 + t * q2
    s = (1 - t) * r0 + t * r1
    left_b = np.stack([c0, q0, r0, s], axis=1)
    right_b = np.stack([s, r1, q2, c3], axis=1)
    sl = (1 - t) * c0 + t * c3
    left_l = np.stack([c0, (2 * c0 + sl) / 3, (c0 + 2 * sl) / 3, sl], axis=1)
    right_l = np.stack([sl, (2 * sl + c3) / 3, (sl + 2 * c3) / 3, c3], axis=1)
    sel = is_bezier[:, None, None]
    return np.where(sel, left_b, left_l), np.where(sel, right_b, right_l)


def np_trim(cp, from_t, end_t, is_bezier):
    """The [from_t, end_t] piece; end_t applies to the re-parameterised
    right part, as the reference does."""
    from_t = np.clip(from_t, 0.0, 1.0)
    end_t = np.clip(end_t, 0.0, 1.0)
    _, right = np_de_casteljau_split(cp, from_t, is_bezier)
    left, _ = np_de_casteljau_split(right, end_t, is_bezier)
    return left


# ---------------------------------------------------------------------------
# extract / repack
# ---------------------------------------------------------------------------


def extract(ts: TrainState) -> HostCurves:
    """The alive rows of `ts` as numpy, one device-to-host copy per tensor."""
    idx = torch.nonzero(ts.alive).squeeze(1)
    m = ts.params["mask_raw"].shape[1]

    def host(t):
        return t.index_select(0, idx).cpu().numpy()

    def rows(d):
        return {k: host(d[k]) for k in PARAM_KEYS}

    return HostCurves(
        params=rows(ts.params),
        mu=rows(ts.opt.mu),
        nu=rows(ts.opt.nu),
        is_bezier=host(ts.is_bezier),
        grad_accum=host(ts.xyz_grad_accum.reshape(-1, m)),
        denom=host(ts.denom.reshape(-1, m)),
        max_radii=host(ts.max_radii.reshape(-1, m)),
    )


def repack(host: HostCurves, ts: TrainState, capacity: Optional[int] = None) -> TrainState:
    """A TrainState at a power-of-two capacity (or `capacity`) on the
    device of `ts`, each tensor in the dtype of its counterpart in `ts`."""
    n, m = host.n, host.m
    cap = capacity or max(round_capacity(n), MIN_CAPACITY)
    dev = ts.alive.device

    def pad(x, like):
        out = np.zeros((cap,) + x.shape[1:], dtype=x.dtype)
        out[:n] = x
        return torch.as_tensor(out, device=dev).to(like.dtype)

    def group(h, d):
        g = {k: pad(h[k], d[k]) for k in PARAM_KEYS}
        g["exposure"] = d["exposure"]
        return g

    return TrainState(
        params=group(host.params, ts.params),
        opt=AdamState(mu=group(host.mu, ts.opt.mu), nu=group(host.nu, ts.opt.nu),
                      count=ts.opt.count),
        is_bezier=pad(host.is_bezier.astype(bool), ts.is_bezier),
        alive=torch.arange(cap, device=dev) < n,
        xyz_grad_accum=pad(host.grad_accum, ts.xyz_grad_accum).reshape(-1),
        denom=pad(host.denom, ts.denom).reshape(-1),
        max_radii=pad(host.max_radii, ts.max_radii).reshape(-1),
        step=ts.step,
        opacity_frozen=ts.opacity_frozen,
    )


# ---------------------------------------------------------------------------
# primitive edits
# ---------------------------------------------------------------------------


def keep(host: HostCurves, keep_mask: np.ndarray) -> HostCurves:
    """Prune: slice params, moments and statistics."""
    k = np.asarray(keep_mask, bool)
    return HostCurves(
        params={key: v[k] for key, v in host.params.items()},
        mu={key: v[k] for key, v in host.mu.items()},
        nu={key: v[k] for key, v in host.nu.items()},
        is_bezier=host.is_bezier[k],
        grad_accum=host.grad_accum[k],
        denom=host.denom[k],
        max_radii=host.max_radii[k],
    )


def append(host: HostCurves, new_params: Dict[str, np.ndarray],
           new_is_bezier: np.ndarray) -> HostCurves:
    """Concatenate new rows with zero moments; the densification
    statistics reset for every row."""
    k = len(new_is_bezier)

    def zeros_after(d):
        return {key: np.concatenate([d[key], np.zeros((k,) + d[key].shape[1:], d[key].dtype)])
                for key in PARAM_KEYS}

    params = {
        key: np.concatenate([host.params[key], new_params[key].astype(host.params[key].dtype)])
        for key in PARAM_KEYS
    }
    n, m = host.n + k, host.m
    return HostCurves(
        params=params,
        mu=zeros_after(host.mu),
        nu=zeros_after(host.nu),
        is_bezier=np.concatenate([host.is_bezier, new_is_bezier.astype(bool)]),
        grad_accum=np.zeros((n, m), np.float32),
        denom=np.zeros((n, m), np.float32),
        max_radii=np.zeros((n, m), np.int32),
    )


def _default_new_params(host, cp, opacity_raw, width_raw):
    m = host.m
    k = len(cp)
    return {
        "curve_points": cp.astype(np.float32),
        "opacity_raw": np.asarray(opacity_raw, np.float32).reshape(k),
        "width_raw": np.asarray(width_raw, np.float32).reshape(k),
        "mask_raw": np.ones((k, m), np.float32),
        "features_dc": np.zeros((k, m, 1), np.float32),
    }


def split_curves(host: HostCurves, selected: np.ndarray, t: np.ndarray) -> HostCurves:
    """Replace the selected curves by their two De Casteljau halves, which
    inherit every attribute (with fresh moments)."""
    sel = np.asarray(selected, bool)
    if not sel.any():
        return host
    cp = host.params["curve_points"][sel]
    left, right = np_de_casteljau_split(cp, np.asarray(t).reshape(-1), host.is_bezier[sel])
    new_params = {"curve_points": np.concatenate([left, right]).astype(np.float32)}
    for key in ("opacity_raw", "width_raw", "mask_raw", "features_dc"):
        v = host.params[key][sel]
        new_params[key] = np.concatenate([v, v])
    new_is_bez = np.concatenate([host.is_bezier[sel]] * 2)
    host = append(host, new_params, new_is_bez)
    keep_mask = np.ones(host.n, bool)
    keep_mask[: len(sel)] = ~sel
    return keep(host, keep_mask)


# ---------------------------------------------------------------------------
# the reference's schedule ops
# ---------------------------------------------------------------------------


def densify_and_prune(host: HostCurves, max_grad: float, min_opacity: float) -> HostCurves:
    """Split curves whose largest mean screen gradient reaches max_grad, at
    that sample; then prune curves below min_opacity."""
    m = host.m
    with np.errstate(invalid="ignore", divide="ignore"):
        grads = host.grad_accum / host.denom
    grads = np.nan_to_num(grads)
    max_vals = grads.max(axis=1)
    arg = grads.argmax(axis=1)
    sel = max_vals >= max_grad
    if sel.any():
        host = split_curves(host, sel, sample_t_mid(m)[arg[sel]])
    opa = 1.0 / (1.0 + np.exp(-host.params["opacity_raw"]))
    return keep(host, ~(opa < min_opacity))


def curve_split_curvature(host: HostCurves, threshold_angle: float = 20.0,
                          threshold_angle_skip: float = 30.0) -> HostCurves:
    """Split where adjacent (or next-but-one) Gaussian axes bend beyond the
    thresholds (degrees)."""
    m = host.m
    t = sample_t_mid(m)
    tan = np_tangent(host.params["curve_points"], t, host.is_bezier)
    tan = tan / (np.linalg.norm(tan, axis=-1, keepdims=True) + 1e-12)
    ang = np.arccos(np.clip(np.einsum("nmc,nmc->nm", tan[:, :-1], tan[:, 1:]), -1, 1))
    ang2 = np.arccos(np.clip(np.einsum("nmc,nmc->nm", tan[:, :-2], tan[:, 2:]), -1, 1))
    sel = ((ang.max(axis=1) > np.deg2rad(threshold_angle))
           | (ang2.max(axis=1) > np.deg2rad(threshold_angle_skip)))
    if not sel.any():
        return host
    split_t = t[ang.argmax(axis=1)] + 0.5 / m
    return split_curves(host, sel, split_t[sel])


def only_prune(host: HostCurves, min_opacity: float, mask_threshold: float) -> HostCurves:
    """Prune mask-dead, transparent or tiny curves."""
    s = 1.0 / (1.0 + np.exp(-host.params["mask_raw"]))
    mask_dead = (s <= mask_threshold).all(axis=1)
    opa = 1.0 / (1.0 + np.exp(-host.params["opacity_raw"]))
    transparent = opa < min_opacity
    # total long-axis length proxy: sum of half-step arc spacings
    m = host.m
    t = sample_t_mid(m)
    cp = host.params["curve_points"]
    p = np_curve_points(cp, t, host.is_bezier)
    pb = np_curve_points(cp, t - 0.5 / m, host.is_bezier)
    tiny = np.linalg.norm(p - pb, axis=-1).sum(axis=1) < 1e-2
    return keep(host, ~(mask_dead | transparent | tiny))


def mask_trim_split(host: HostCurves, mask_threshold: float) -> HostCurves:
    """Trim curve ends whose mask falls below the threshold and re-sample
    the kept span of the mask to M samples (linear, align_corners=False);
    trimmed rows get fresh curve_points and mask moments."""
    m = host.m
    s = 1.0 / (1.0 + np.exp(-host.params["mask_raw"]))
    valid = s > mask_threshold
    any_valid = valid.any(axis=1)
    start = np.where(any_valid, valid.argmax(axis=1), 0)
    end = np.where(any_valid, m - 1 - valid[:, ::-1].argmax(axis=1), m - 1)
    t = sample_t_mid(m)
    from_t = t[start] - 0.5 / m
    end_t = t[end] + 0.5 / m
    changed = any_valid & ((start != 0) | (end != m - 1))
    if not changed.any():
        return host
    cp = host.params["curve_points"]
    trimmed = np_trim(cp, from_t, end_t, host.is_bezier)
    new_cp = np.where(changed[:, None, None], trimmed, cp)
    new_mask = np.array(host.params["mask_raw"], copy=True)
    for i in np.where(changed)[0]:
        span = host.params["mask_raw"][i, start[i]: end[i] + 1]
        k = len(span)
        pos = (np.arange(m) + 0.5) * k / m - 0.5
        new_mask[i] = np.interp(pos, np.arange(k), span)
    host.params["curve_points"] = new_cp.astype(np.float32)
    host.params["mask_raw"] = new_mask.astype(np.float32)
    for d in (host.mu, host.nu):
        d["curve_points"][changed] = 0.0
        d["mask_raw"][changed] = 0.0
    return host


def fit_curve_to_line(host: HostCurves, threshold: float = 0.0015,
                      threshold_max: float = 0.005, sample_num: int = 100) -> HostCurves:
    """Convert near-straight Béziers to line segments with the PCA fit's
    endpoints, zeroing those rows' curve_points moments (the reference's
    endpoint write is a no-op; this is its intent)."""
    t = np.linspace(0.0, 1.0, sample_num)
    cp = host.params["curve_points"]
    pts = np_curve_points(cp, t, host.is_bezier)
    changed = np.zeros(host.n, bool)
    for i in np.where(host.is_bezier)[0]:
        start, end, direction, mean, tmin, tmax = fitting.fit_line_pca(pts[i])
        proj = np.clip((pts[i] - mean) @ direction, tmin, tmax)
        closest = mean + proj[:, None] * direction
        d = np.linalg.norm(pts[i] - closest, axis=1)
        if d.mean() < threshold and d.max() < threshold_max:
            changed[i] = True
            host.is_bezier[i] = False
            cp[i, 0] = start
            cp[i, 3] = end
            cp[i, 1] = start + (end - start) / 3
            cp[i, 2] = start + 2 * (end - start) / 3
    if changed.any():
        for d in (host.mu, host.nu):
            d["curve_points"][changed] = 0.0
    return host


def merge_curves(
    host: HostCurves,
    distance_threshold: float = 0.02,
    similarity_threshold: float = 0.97,
    sample_num: int = 100,
    ransac_thresh: float = 0.005,
    seed: int = 0,
) -> HostCurves:
    """Merge Bézier pairs with matching endpoints and tangents into one
    refitted Bézier, and collinear line components into one segment."""
    n = host.n
    if n == 0:
        return host
    t = np.linspace(0.0, 1.0, sample_num)
    cp = host.params["curve_points"]
    samples = np_curve_points(cp, t, host.is_bezier)  # [n, S, 3]

    all_pts = np.concatenate([cp[:, 0], cp[:, 3]], axis=0)
    all_tan = np.concatenate([cp[:, 1] - cp[:, 0], cp[:, 2] - cp[:, 3]], axis=0)
    all_tan = all_tan / (np.linalg.norm(all_tan, axis=1, keepdims=True) + 1e-6)
    sim = np.abs(all_tan @ all_tan.T)
    dist = np.linalg.norm(all_pts[:, None] - all_pts[None], axis=-1)
    mm = (dist < 2 * distance_threshold) & (sim > similarity_threshold)
    adj = mm[:n, :n] | mm[:n, n:] | mm[n:, :n] | mm[n:, n:]
    conf = np.maximum(np.maximum(sim[:n, :n], sim[:n, n:]), np.maximum(sim[n:, :n], sim[n:, n:]))

    merged = set()
    pairs = []
    for i in range(n):
        if i in merged or not host.is_bezier[i]:
            continue
        neigh = [j for j in np.where(adj[i])[0]
                 if j not in merged and j != i and host.is_bezier[j]]
        if not neigh:
            continue
        best = max(neigh, key=lambda j: conf[i, j])
        merged.add(i)
        merged.add(best)
        pairs.append((i, best))

    remove = np.zeros(n, bool)
    new_cp, new_opa, new_wid, new_bez = [], [], [], []
    for i, j in pairs:
        pts = np.concatenate([samples[i], samples[j]], axis=0)
        inliers = fitting.ransac_line(pts, ransac_thresh, seed=seed)
        if inliers.sum() < 2:
            continue
        start, end, direction, mean, *_ = fitting.fit_line_pca(pts[inliers])
        order = np.argsort((pts - mean) @ direction)
        fit = fitting.fit_bezier_lsq(pts[order], error_threshold=distance_threshold)
        if fit is None:
            continue
        remove[[i, j]] = True
        new_cp.append(fit)
        new_opa.append(host.params["opacity_raw"][[i, j]].mean())
        new_wid.append(host.params["width_raw"][[i, j]].mean())
        new_bez.append(True)

    # line-segment components
    line_idx = np.where(~host.is_bezier)[0]
    if len(line_idx) > 1:
        segs = cp[line_idx][:, [0, 3], :].reshape(len(line_idx), 6)
        dmat = fitting.pairwise_segment_distances(segs)
        smat = np.abs(fitting.pairwise_cosine_similarity(segs))
        ladj = (dmat <= distance_threshold) & (smat >= similarity_threshold)
        ncomp, labels = connected_components(csr_matrix(ladj))
        for c in range(ncomp):
            comp = line_idx[np.where(labels == c)[0]]
            if len(comp) <= 1:
                continue
            remove[comp] = True
            start, end, *_ = fitting.fit_line_pca(samples[comp].reshape(-1, 3))
            out = np.zeros((4, 3), np.float32)
            out[0], out[3] = start, end
            out[1] = start + (end - start) / 3
            out[2] = start + 2 * (end - start) / 3
            new_cp.append(out)
            new_opa.append(host.params["opacity_raw"][comp].mean())
            new_wid.append(host.params["width_raw"][comp].mean())
            new_bez.append(False)

    if not remove.any():
        return host
    host = keep(host, ~remove)
    new_params = _default_new_params(host, np.stack(new_cp), np.asarray(new_opa),
                                     np.asarray(new_wid))
    return append(host, new_params, np.asarray(new_bez))


def fix_opacity_host(host: HostCurves, floor: float = 0.6) -> HostCurves:
    """Raise opacities to the floor and zero their moments; the caller sets
    the frozen flag."""
    opa = np.maximum(1.0 / (1.0 + np.exp(-host.params["opacity_raw"])), floor)
    host.params["opacity_raw"] = inverse_sigmoid_np(opa).astype(np.float32)
    host.mu["opacity_raw"][:] = 0.0
    host.nu["opacity_raw"][:] = 0.0
    return host


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


SCHEDULE_OPS = ("densify", "densify_until", "prune_trim", "split", "merge")


def _fires(iteration: int, opt: OptimizationConfig):
    """Which of the schedule's edits (``SCHEDULE_OPS``) run at `iteration`.  The cadences come from the
    config (the reference's literals as defaults: prune/trim at
    %1000 == 500, split at %1000 == 0 past 3000, merge at %1000 == 0 past
    densify_until and at the last iteration)."""
    pti, si, mi = opt.prune_trim_interval, opt.split_interval, opt.merge_interval
    return (
        opt.densify_from_iter < iteration < opt.densify_until_iter
        and iteration % opt.densification_interval == 0,
        iteration == opt.densify_until_iter,
        iteration % pti == pti // 2 and iteration > opt.densify_until_iter,
        iteration % si == 0 and iteration > opt.split_from_iter and iteration != opt.iterations,
        (iteration % mi == 0 and iteration > opt.densify_until_iter)
        or iteration == opt.iterations,
    )


def fired_ops(iteration: int, opt: OptimizationConfig):
    """The names of the edits that run at `iteration`, in order."""
    return [op for op, on in zip(SCHEDULE_OPS, _fires(iteration, opt)) if on]


def schedule_fires(iteration: int, opt: OptimizationConfig) -> bool:
    """True when apply_schedule does any work at `iteration`: the training
    loop ends a chunk there."""
    return any(_fires(iteration, opt))


def apply_schedule(ts: TrainState, iteration: int, opt: OptimizationConfig,
                   span=None) -> TrainState:
    """Run the surgery the schedule prescribes at `iteration`; returns a
    (possibly re-bucketed) TrainState, or `ts` itself when nothing fires.
    At densify_until the opacities are fixed and frozen.  `span`, given,
    is a context manager factory: each fired edit of ``SCHEDULE_OPS`` runs
    inside ``span(op)`` (the host copy and the repack outside them)."""
    densify, until, prune_trim, split, merge = _fires(iteration, opt)
    acts = {}  # the edits of each op that fires, in order
    if densify:
        acts["densify"] = [lambda h: densify_and_prune(h, opt.densify_grad_threshold,
                                                       opt.opacity_cull)]
    if until:
        acts["densify_until"] = [lambda h: keep(
            h, ~(1.0 / (1.0 + np.exp(-h.params["opacity_raw"])) <= opt.opacity_cull_second)),
            fix_opacity_host]
    if prune_trim:
        acts["prune_trim"] = [lambda h: only_prune(h, opt.opacity_cull, opt.mask_threshold),
                              lambda h: mask_trim_split(h, opt.mask_threshold)]
    if split:
        acts["split"] = [lambda h: curve_split_curvature(h, opt.threshold_angle,
                                                         opt.threshold_angle_skip)]
    if merge:
        acts["merge"] = [lambda h: fit_curve_to_line(h, opt.threshold_line,
                                                     opt.threshold_max_line),
                         lambda h: merge_curves(h, opt.distance_threshold,
                                                opt.similarity_threshold, seed=iteration)]
    if not acts:
        return ts
    host = extract(ts)
    for op, edits in acts.items():
        with span(op) if span is not None else contextlib.nullcontext():
            for edit in edits:
                host = edit(host)
    new_ts = repack(host, ts)
    if until:
        new_ts = dataclasses.replace(new_ts, opacity_frozen=True)
    return new_ts
