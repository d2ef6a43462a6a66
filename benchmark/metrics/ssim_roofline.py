"""ssim_roofline: the SSIM kernels' share of their roofline: the least
time of K7 (``ssim_fwd_kernel``) and K8 (``ssim_bwd_kernel``) at the
view's size by the benchmark's own counts (``counts.py``), times the
profiled chunk's steps and views, over the two kernels' device time in the
profile by name (peaks of the H100 SXM at 700 W)."""

from benchmark import counts

KERNELS = ("ssim_fwd_kernel", "ssim_bwd_kernel")


def read(ctx):
    device_s = sum(e - s for n, s, e in ctx["trace"].kernels if any(k in n for k in KERNELS))
    if device_s <= 0:
        return None
    least = sum(counts.ssim_seconds(ctx["height"], ctx["width"]).values())
    return 100.0 * least * ctx["traced_steps"] * ctx["views_per_step"] / device_s
