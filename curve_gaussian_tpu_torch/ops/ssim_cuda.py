"""Fused SSIM: kernels K7 (value) and K8 (input gradients).

K7 ``ssim_fwd`` replaces ``curve_gaussian_tpu/ops/ssim_pallas.py::_fwd_kernel``
and K8 ``ssim_bwd`` replaces ``_bwd_kernel``: mean SSIM of two single-channel
[H, W] images with the 11-tap sigma-1.5 window and exact 'same' zero
padding, and its gradient with respect to both images.  K8 recomputes the
moments on a halo tile, forms the four d(SSIM)/d(moment) maps scaled by
g / (H W) and zero outside the image, and applies the adjoint blur, which
is the blur itself because the window is symmetric.

What sets their time on an H100: 250-450 float operations per pixel
against 8-16 bytes of device memory, so instruction issue, not bytes.  The
first design (16x16 tiles, one output per thread and pass) spent it on
shared-memory loads of inputs and taps, on K8's halo (moments on 26x26 for
a 16x16 tile) and on 1.55 waves of K8's blocks, and K7's value took three
launches: 0.0178 ms (K7) and 0.0278 ms (K8) on an H100 80GB HBM3 at 700 W.
The current design passes the taps by value, makes R outputs per thread
and pass from R + 10 values held in registers, takes 32x32 tiles (one wave
of 256 blocks at 512x512) and ends K7 in its own launch: the block that
takes the last ticket adds the per-block partial sums in a fixed order, so
the value is the same from run to run.  On the same card K7 takes 0.0108
ms and K8 0.0155 ms; ptxas gives K7 64 registers and 42,168 B of dynamic
shared memory (4 blocks per SM), K8 86 and 95,664 B (2 per SM).
``csrc/ssim.cu`` has the design note, ``PERF.md`` §6 the measurements.

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
TILE = 32  # the kernels' output tile edge (csrc/ssim.cu: TW, TH); one K7 partial each

_VP = ctypes.c_void_p
_I = ctypes.c_int


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalised 1-D Gaussian taps, rounded to float32 (as the JAX package's)."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


# the kernels' taps, read from host memory into a kernel argument at launch
_TAPS = gaussian_window(KERNEL_WINDOW)


@functools.lru_cache(maxsize=None)
def _window(window_size: int, dtype, device) -> torch.Tensor:
    """The plain versions' taps on `device`, copied there once: a copy from
    host memory synchronises the stream, which a training step must not do."""
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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ssim")
    lib.ssim_prepare.argtypes = []
    lib.ssim_prepare.restype = _I
    lib.ssim_fwd.argtypes = [_VP] * 6 + [_I] * 2 + [_VP]
    lib.ssim_fwd.restype = _I
    lib.ssim_bwd.argtypes = [_VP] * 6 + [_I] * 2 + [_VP]
    lib.ssim_bwd.restype = _I
    lib.ssim_launch_shape.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 4
    lib.ssim_launch_shape.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _prepare(device) -> torch.Tensor:
    """Once per device, before its first launch: lets K7 and K8 take their
    dynamic shared memory there (``ssim_prepare``) and returns K7's ticket
    counter, zeroed once; each launch leaves it at 0.  One counter per
    device: the port runs one stream per device."""
    lib = _lib()
    with torch.cuda.device(device):
        _build.check(lib, lib.ssim_prepare(), "ssim_prepare")
    return torch.zeros(1, dtype=torch.int32, device=device)


def _check_pair(img1, img2, window_size):
    if window_size != KERNEL_WINDOW:
        raise ValueError(f"the SSIM kernels take window_size={KERNEL_WINDOW}, got {window_size}")
    for name, t in (("img1", img1), ("img2", img2)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [H, W] tensor")
    if img1.shape != img2.shape or img1.device != img2.device:
        raise ValueError("img1 and img2 must have one shape and one device")


def ssim_fwd(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """K7: mean SSIM of two [H, W] images (a 0-dim tensor), in one launch."""
    if not img1.is_cuda:
        return ssim_fwd_plain(img1, img2, window_size)
    _check_pair(img1, img2, window_size)
    H, W = img1.shape
    ticket = _prepare(img1.device)
    partial = torch.empty(-(-H // TILE) * -(-W // TILE), dtype=torch.float32, device=img1.device)
    out = torch.empty((), dtype=torch.float32, device=img1.device)
    lib = _lib()
    code = lib.ssim_fwd(
        img1.data_ptr(), img2.data_ptr(), _TAPS.ctypes.data, partial.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), H, W,
        torch.cuda.current_stream(img1.device).cuda_stream,
    )
    _build.check(lib, code, "ssim_fwd")
    ssim_fwd.launches += 1
    return out


def ssim_bwd(img1: torch.Tensor, img2: torch.Tensor, g: torch.Tensor, window_size: int = 11):
    """K8: (dimg1, dimg2) [H, W] of g * mean SSIM; g is a one-element tensor."""
    if not img1.is_cuda:
        return ssim_bwd_plain(img1, img2, g, window_size)
    _check_pair(img1, img2, window_size)
    if g.dtype != torch.float32 or g.numel() != 1 or g.device != img1.device:
        raise ValueError("g must be a float32 tensor of one element on the images' device")
    H, W = img1.shape
    _prepare(img1.device)
    g = g.contiguous()
    d1 = torch.empty_like(img1)
    d2 = torch.empty_like(img1)
    lib = _lib()
    code = lib.ssim_bwd(
        img1.data_ptr(), img2.data_ptr(), _TAPS.ctypes.data, g.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), H, W, torch.cuda.current_stream(img1.device).cuda_stream,
    )
    _build.check(lib, code, "ssim_bwd")
    ssim_bwd.launches += 1
    return d1, d2


ssim_fwd.launches = 0
ssim_bwd.launches = 0


def launch_shape(which: str, H: int, W: int) -> dict:
    """K7's (``"ssim_fwd"``) or K8's (``"ssim_bwd"``) launch at [H, W] on the
    current card: blocks, threads per block, dynamic shared memory and the
    blocks resident per SM (the CUDA occupancy calculator)."""
    _prepare(torch.device("cuda", torch.cuda.current_device()))
    lib = _lib()
    vals = [_I() for _ in range(4)]
    code = lib.ssim_launch_shape({"ssim_fwd": 0, "ssim_bwd": 1}[which], H, W,
                                 *(ctypes.byref(v) for v in vals))
    _build.check(lib, code, f"launch_shape {which}")
    return dict(zip(("blocks", "threads", "smem", "per_sm"), (v.value for v in vals)))


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
