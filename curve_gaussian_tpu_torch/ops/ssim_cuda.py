"""Fused SSIM: kernels K7 (value) and K8 (input gradients).

K7 ``ssim_fwd`` replaces ``curve_gaussian_tpu/ops/ssim_pallas.py::_fwd_kernel``
and K8 ``ssim_bwd`` replaces ``_bwd_kernel``: mean SSIM of two single-channel
[H, W] images with the 11-tap sigma-1.5 window and exact 'same' zero
padding, and its gradient with respect to both images.  K7 writes one
partial sum per 16x16 tile and the wrapper adds them and divides by H*W;
K8 recomputes the moments on a halo tile, forms the four
d(SSIM)/d(moment) maps scaled by g / (H W) and zero outside the image, and
applies the adjoint blur, which is the blur itself because the window is
symmetric.

What bounds them on an H100: about 250 (K7) and 450 (K8) float operations
per pixel against 8 and 16 bytes of device memory, so instruction
throughput, not bytes; see ``csrc/ssim.cu`` for the design.

Every wrapper takes the plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.  The plain versions accept
float32 and float64; the kernels take float32 and the 11-tap window.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

C1 = 0.01**2
C2 = 0.03**2
KERNEL_WINDOW = 11

_VP = ctypes.c_void_p
_I = ctypes.c_int


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalised 1-D Gaussian taps, rounded to float32 (as the JAX package's)."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(window_size: int, dtype, device) -> torch.Tensor:
    """The taps on `device`, copied there once: a copy from host memory
    synchronises the stream, which a training step must not do."""
    return torch.tensor(gaussian_window(window_size), dtype=dtype, device=device)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable 'same' blur of [H, W] with zero padding: horizontal taps
    then vertical, each summed in tap order."""
    H, W = x.shape
    half = w.shape[0] // 2
    xp = F.pad(x, (half, half))
    h = sum(w[k] * xp[:, k : k + W] for k in range(w.shape[0]))
    hp = F.pad(h, (0, 0, half, half))
    return sum(w[k] * hp[k : k + H, :] for k in range(w.shape[0]))


def _moments(img1, img2, w):
    return tuple(_blur(m, w) for m in (img1, img2, img1 * img1, img2 * img2, img1 * img2))


def ssim_fwd_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """Plain PyTorch K7: mean SSIM (a 0-dim tensor)."""
    H, W = img1.shape
    mu1, mu2, e11, e22, e12 = _moments(img1, img2, _window(window_size, img1.dtype, img1.device))
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    ssim_map = ((2.0 * mu12 + C1) * (2.0 * (e12 - mu12) + C2)) / (
        (mu1_sq + mu2_sq + C1) * ((e11 - mu1_sq) + (e22 - mu2_sq) + C2)
    )
    return ssim_map.sum() / (H * W)


def ssim_bwd_plain(img1, img2, g, window_size: int = 11):
    """Plain PyTorch K8: (dimg1, dimg2) of g * mean SSIM."""
    H, W = img1.shape
    w = _window(window_size, img1.dtype, img1.device)
    mu1, mu2, e11, e22, e12 = _moments(img1, img2, w)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    A1 = 2.0 * mu12 + C1
    A2 = 2.0 * (e12 - mu12) + C2
    B1 = mu1_sq + mu2_sq + C1
    B2 = (e11 - mu1_sq) + (e22 - mu2_sq) + C2
    inv = 1.0 / (B1 * B2)
    ssim_v = A1 * A2 * inv
    dA1 = A2 * inv
    dA2 = A1 * inv
    dB1 = -ssim_v / B1
    dB2 = -ssim_v / B2
    gs = g.reshape(()) / (H * W)
    dmu1 = gs * 2.0 * (mu2 * (dA1 - dA2) + mu1 * (dB1 - dB2))
    dmu2 = gs * 2.0 * (mu1 * (dA1 - dA2) + mu2 * (dB1 - dB2))
    de = gs * dB2
    de12 = gs * 2.0 * dA2
    a_mu1, a_mu2, a_e, a_e12 = (_blur(m, w) for m in (dmu1, dmu2, de, de12))
    d1 = a_mu1 + 2.0 * img1 * a_e + img2 * a_e12
    d2 = a_mu2 + 2.0 * img2 * a_e + img1 * a_e12
    return d1, d2


def _lib():
    lib = _build.load("ssim")
    if not getattr(lib, "_typed", False):
        lib.ssim_fwd.argtypes = [_VP] * 4 + [_I] * 2 + [_VP]
        lib.ssim_fwd.restype = _I
        lib.ssim_bwd.argtypes = [_VP] * 6 + [_I] * 2 + [_VP]
        lib.ssim_bwd.restype = _I
        lib._typed = True
    return lib


def _check_pair(img1, img2, window_size):
    if window_size != KERNEL_WINDOW:
        raise ValueError(f"the SSIM kernels take window_size={KERNEL_WINDOW}, got {window_size}")
    for name, t in (("img1", img1), ("img2", img2)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [H, W] tensor")
    if img1.shape != img2.shape or img1.device != img2.device:
        raise ValueError("img1 and img2 must have one shape and one device")


def _tiles(H: int, W: int):
    return -(-W // 16), -(-H // 16)


def ssim_fwd(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """K7: mean SSIM of two [H, W] images (a 0-dim tensor)."""
    if not img1.is_cuda:
        return ssim_fwd_plain(img1, img2, window_size)
    _check_pair(img1, img2, window_size)
    H, W = img1.shape
    gx, gy = _tiles(H, W)
    partial = torch.empty(gx * gy, dtype=torch.float32, device=img1.device)
    win = _window(window_size, torch.float32, img1.device)
    lib = _lib()
    code = lib.ssim_fwd(
        img1.data_ptr(), img2.data_ptr(), win.data_ptr(), partial.data_ptr(), H, W,
        torch.cuda.current_stream(img1.device).cuda_stream,
    )
    _build.check(lib, code, "ssim_fwd")
    ssim_fwd.launches += 1
    return partial.sum() / (H * W)


def ssim_bwd(img1: torch.Tensor, img2: torch.Tensor, g: torch.Tensor, window_size: int = 11):
    """K8: (dimg1, dimg2) [H, W] of g * mean SSIM; g is a one-element tensor."""
    if not img1.is_cuda:
        return ssim_bwd_plain(img1, img2, g, window_size)
    _check_pair(img1, img2, window_size)
    if g.dtype != torch.float32 or g.numel() != 1 or g.device != img1.device:
        raise ValueError("g must be a float32 tensor of one element on the images' device")
    H, W = img1.shape
    d1 = torch.empty_like(img1)
    d2 = torch.empty_like(img1)
    g = g.contiguous()
    win = _window(window_size, torch.float32, img1.device)
    lib = _lib()
    code = lib.ssim_bwd(
        img1.data_ptr(), img2.data_ptr(), win.data_ptr(), g.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), H, W, torch.cuda.current_stream(img1.device).cuda_stream,
    )
    _build.check(lib, code, "ssim_bwd")
    ssim_bwd.launches += 1
    return d1, d2


ssim_fwd.launches = 0
ssim_bwd.launches = 0


class SSIMFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2, window_size: int = 11):
        img1 = img1.contiguous()
        img2 = img2.contiguous()
        ctx.save_for_backward(img1, img2)
        ctx.window_size = window_size
        return ssim_fwd(img1, img2, window_size)

    @staticmethod
    def backward(ctx, g):
        img1, img2 = ctx.saved_tensors
        d1, d2 = ssim_bwd(img1, img2, g, ctx.window_size)
        return d1, d2, None


def ssim_fused(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """Differentiable mean SSIM of a single-channel [H, W] pair."""
    return SSIMFused.apply(img1, img2, window_size)
