"""Seeded families of conics and opacities that stress the support box of
the training blend kernels K1 and K2: thin, wide, axis-aligned, rotated
and near-degenerate conics, opacities near 1/255 and near 1, means outside
the 64x64 neighbourhood (pixels 0..63), and pixels placed where the box
touches the ellipse.

The module imports no JAX and holds no test of its own:
``test_torch_port_cull.py`` holds the box's float32 mirror against float64
and float32 gates over these families on the CPU, and
``test_torch_port_isolation.py`` holds the kernels' own box (device
``logf``/``sqrtf``) against the plain versions over them on the card,
where there is no JAX.
"""
import numpy as np
import torch

from curve_gaussian_tpu_torch.ops.rasterize_ref import ALPHA_EPS

N = 1500  # conics per family
NB = 64  # the neighbourhood: pixels (0..63, 0..63)


def _conics(rng, family):
    """(ca, cb, cc) float64 [N] of one family, from a covariance
    R diag(s1^2, s2^2) R^T (the dilated 2D covariance of a splat: s >= 0.55)
    or, near-degenerate, from cb^2 = ca cc (1 - d)^2."""
    if family == "near_degenerate":
        ca = 10.0 ** rng.uniform(-4, 1, N)
        cc = 10.0 ** rng.uniform(-4, 1, N)
        d = 10.0 ** rng.uniform(-9, -2, N)
        cb = rng.choice([-1.0, 1.0], N) * np.sqrt(ca * cc) * (1.0 - d)
        return ca, cb, cc
    s1, s2 = {
        "thin": (10.0 ** rng.uniform(0.3, 2.5, N), rng.uniform(0.55, 1.5, N)),
        "wide": (10.0 ** rng.uniform(1, 2.6, N), 10.0 ** rng.uniform(1, 2.6, N)),
        "axis_aligned": (10.0 ** rng.uniform(0.3, 2.5, N), rng.uniform(0.55, 1.5, N)),
        "opacity_edges": (10.0 ** rng.uniform(-0.3, 1.5, N), 10.0 ** rng.uniform(-0.3, 1.5, N)),
        "means_outside": (10.0 ** rng.uniform(0, 2, N), rng.uniform(0.55, 3.0, N)),
        "tangent": (10.0 ** rng.uniform(0, 2, N), 10.0 ** rng.uniform(-0.25, 1, N)),
    }[family]
    th = rng.choice([0.0, np.pi / 2], N) if family == "axis_aligned" else rng.uniform(0, np.pi, N)
    c, s = np.cos(th), np.sin(th)
    sxx = c * c * s1**2 + s * s * s2**2
    syy = s * s * s1**2 + c * c * s2**2
    sxy = c * s * (s1**2 - s2**2)
    det = sxx * syy - sxy * sxy
    return syy / det, -sxy / det, sxx / det


def family_rows(family):
    """float32 field rows [N, 8] of one family."""
    rng = np.random.default_rng(FAMILIES.index(family))
    ca, cb, cc = _conics(rng, family)
    if family == "opacity_edges":
        e = np.float32(ALPHA_EPS)
        op = np.concatenate([e * (1.0 + rng.uniform(-2e-5, 1e-2, N // 3)),
                             np.full(N // 3, e), rng.uniform(0.98, 1.0, N - 2 * (N // 3))])
    else:
        op = 10.0 ** rng.uniform(np.log10(ALPHA_EPS), 0.0, N)
    lo, hi = (-150.0, NB + 150.0) if family == "means_outside" else (-8.0, NB + 8.0)
    mx, my = rng.uniform(lo, hi, N), rng.uniform(lo, hi, N)
    if family == "means_outside":  # push every mean out of the neighbourhood
        out = (mx >= 0) & (mx < NB) & (my >= 0) & (my < NB)
        mx = np.where(out, mx - NB - 20.0, mx)
    if family == "tangent":
        # the pixel (32, 32) sits where the box touches the ellipse
        # -power <= t + 5e-6, in one of four directions: in the float64
        # gate's slack, at the edge of the box
        op = 10.0 ** rng.uniform(-2, 0, N)
        t = np.log(255.0 * op) + 5e-6
        det = ca * cc - cb * cb
        along_x = np.arange(N) % 2 == 0
        dvec = np.where(along_x[:, None],
                        np.sqrt(2 * t / (cc * det))[:, None] * np.stack([cc, -cb], -1),
                        np.sqrt(2 * t / (ca * det))[:, None] * np.stack([-cb, ca], -1))
        dvec *= np.where(np.arange(N) % 4 < 2, 1.0, -1.0)[:, None]
        mx, my = NB // 2 + dvec[:, 0], NB // 2 + dvec[:, 1]
    z = np.zeros(N)
    return torch.tensor(np.stack([mx, my, ca, cb, cc, op, z, z], -1), dtype=torch.float32)


FAMILIES = ["thin", "wide", "axis_aligned", "near_degenerate", "opacity_edges", "means_outside",
            "tangent"]


def packed_family(family, device):
    """One family as blend inputs: each row in a 64x64 block of 2x2 tiles of
    its own (its mean shifted by the block's origin, which rounds it in
    float32), listed in those four tiles only (K = 1), so that the blend
    meets every conic at the pixels of its neighbourhood and nothing hides
    it.  Returns (H, W, fields, gidx, counts), an image of 39x39 blocks."""
    rows = family_rows(family)
    nb = int(np.ceil(np.sqrt(N)))
    H = W = NB * nb
    ntx = W // 32
    b = torch.arange(N)
    bx, by = b % nb, b // nb
    fields = rows.clone()
    fields[:, 0] += (NB * bx).float()
    fields[:, 1] += (NB * by).float()
    gidx = torch.zeros((ntx * ntx, 1), dtype=torch.int32)
    counts = torch.zeros(ntx * ntx, dtype=torch.int32)
    for a in (0, 1):
        for c in (0, 1):
            t = (2 * by + a) * ntx + 2 * bx + c
            gidx[t, 0] = b.to(torch.int32)
            counts[t] = 1
    return H, W, fields.to(device), gidx.to(device), counts.to(device)


def slots_table(gidx, counts, P: int) -> np.ndarray:
    """[R, P] int32 from a [T, K] table, built in numpy: column p lists the
    slot rows tile * K + j (j < counts[tile]) that hold Gaussian p, in
    ascending (tile, slot) order, then -1; R is the most any Gaussian holds
    (at least 1).  The layout of ``Binning.slots``, without its rect order's
    gaps, for tables made by hand."""
    g = np.asarray(gidx.cpu() if torch.is_tensor(gidx) else gidx)
    c = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    T, K = g.shape
    lists = [[] for _ in range(P)]
    for t in range(T):
        for j in range(int(c[t])):
            if g[t, j] < P:
                lists[g[t, j]].append(t * K + j)
    out = np.full((max([1] + [len(v) for v in lists]), P), -1, dtype=np.int32)
    for p, v in enumerate(lists):
        out[: len(v), p] = v
    return out
