"""SSIM for single-channel images, as in ``curve_gaussian_tpu/ops/ssim.py``:
11x11 sigma-1.5 Gaussian window (float32 taps), C1 = 0.01^2, C2 = 0.03^2,
'same' zero padding.

``ssim`` routes a 2-D float32 pair to the fused kernel pair K7/K8 of
``ssim_cuda`` (their plain versions on CPU tensors).  Every other input
([..., H, W] stacks, other dtypes) and ``method="matmul"`` take the
band-matrix path: the separable blur is B_H @ img @ B_W with
B[i, j] = w[j - i + half] inside the band, whose zeros outside it are the
zero 'same' padding; the five moment maps ride one [..., 5, H, W] stack
through two ``torch.matmul``s, and autograd gives the backward (the band
matrices are symmetric, so the gradient blurs are the same products)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .ssim_cuda import C1, C2, gaussian_window, ssim_fused

__all__ = ["C1", "C2", "gaussian_window", "ssim"]


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int) -> np.ndarray:
    """[n, n] banded blur operator: B[i, j] = w[j - i + half] inside the
    band; zero outside, which is zero 'same' padding at the borders."""
    w = gaussian_window(window_size)
    half = window_size // 2
    B = np.zeros((n, n), np.float32)
    for k, wk in enumerate(w):
        off = k - half
        idx = np.arange(max(0, -off), min(n, n - off))
        B[idx, idx + off] = wk
    return B


def _band_on(n: int, window_size: int, dtype, device) -> torch.Tensor:
    """_band_matrix(n) as a tensor on `device` (a copy per call, so no
    device memory outlives it)."""
    return torch.as_tensor(_band_matrix(n, window_size), device=device).to(dtype)


def _blur(img: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Separable 'same' Gaussian blur of [..., H, W] by banded matmuls."""
    h, w = img.shape[-2], img.shape[-1]
    By = _band_on(h, window_size, img.dtype, img.device)
    Bx = _band_on(w, window_size, img.dtype, img.device)
    return torch.matmul(torch.matmul(By, img), Bx)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         method: str | None = None) -> torch.Tensor:
    """Mean SSIM over single-channel images [..., H, W] (differentiable in
    both).  method: None (auto), "fused" (K7/K8; a 2-D float32 pair only)
    or "matmul" (the band-matrix path)."""
    if method not in (None, "fused", "matmul"):
        raise ValueError(f"ssim method {method!r}")
    fusable = img1.dim() == 2 and img1.dtype == torch.float32
    if method == "fused" and not fusable:
        raise ValueError(
            "ssim(method='fused') requires a 2-D float32 image pair, got "
            f"ndim={img1.dim()} dtype={img1.dtype}; use method=None for the matmul path"
        )
    if method != "matmul" and fusable:
        return ssim_fused(img1, img2, window_size)
    stack = torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-3)
    mu1, mu2, e11, e22, e12 = torch.movedim(_blur(stack, window_size), -3, 0)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()
