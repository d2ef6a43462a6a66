"""Mean squared distance to the k nearest neighbours, used once at init to
size the seed curves.  Exact chunked pairwise distances, as in
``curve_gaussian_tpu/ops/knn.py``."""
from __future__ import annotations

import torch


@torch.no_grad()
def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, chunk: int = 4096) -> torch.Tensor:
    """[N,3] -> [N] mean squared distance to the k nearest neighbours."""
    n = points.shape[0]
    if n <= 1:
        return torch.full((n,), 1e-4, dtype=points.dtype, device=points.device)
    k = min(k, n - 1)
    sq = torch.sum(points**2, dim=-1)
    out = []
    cols = torch.arange(n, device=points.device)
    for start in range(0, n, chunk):
        q = points[start : start + chunk]
        d2 = sq[start : start + chunk, None] + sq[None, :] - 2.0 * (q @ points.T)
        rows = torch.arange(start, start + q.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        neg_top, _ = torch.topk(-d2, k, dim=-1)
        out.append(torch.clamp(-neg_top, min=0.0).mean(dim=-1))
    return torch.cat(out)
