"""SSIM for single-channel images, as in ``curve_gaussian_tpu/ops/ssim.py``:
11x11 sigma-1.5 Gaussian window (float32 taps), C1 = 0.01^2, C2 = 0.03^2,
'same' zero padding.  ``ssim`` routes every 2-D pair to the fused kernel
pair K7/K8 of ``ssim_cuda`` (their plain versions on CPU tensors)."""
from __future__ import annotations

import torch

from .ssim_cuda import C1, C2, gaussian_window, ssim_fused

__all__ = ["C1", "C2", "gaussian_window", "ssim"]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [H, W] images (differentiable in both)."""
    if img1.dim() != 2 or img1.shape != img2.shape:
        raise NotImplementedError(
            "ssim takes one [H, W] pair; batched SSIM belongs to the evaluation slice"
        )
    return ssim_fused(img1, img2, window_size)
