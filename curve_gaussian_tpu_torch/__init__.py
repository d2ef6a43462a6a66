"""CurveGaussian in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the ``curve_gaussian_tpu`` JAX package.  It imports neither JAX
nor that package.  Entry points take a ``device`` argument that defaults to
``"cuda"`` and raise when CUDA is absent and the caller did not ask for the
CPU; on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point; raises if CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
