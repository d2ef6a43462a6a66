"""blend_roofline: the training blend's share of its roofline.

The least time of K1 (``blend_train_fwd_kernel``), K2
(``blend_train_bwd_kernel``) and the slot -> Gaussian reduction
(``slot_reduce_kernel``) by the benchmark's own counts (``counts.py``),
taken on the tile lists of every ``run.COUNT_EVERY``-th step of the profiled
chunk and averaged, times its steps and views, over the three kernels'
device time in the profile by name (peaks of the H100 SXM at 700 W)."""

from benchmark import counts

KERNELS = ("blend_train_fwd_kernel", "blend_train_bwd_kernel", "slot_reduce_kernel")


def read(ctx):
    device_s = sum(e - s for n, s, e in ctx["trace"].kernels if any(k in n for k in KERNELS))
    if device_s <= 0 or not ctx["samples"]:
        return None
    least = []
    for smp in ctx["samples"]:
        pairs = counts.pair_counts(smp["fields"], smp["gidx"], smp["counts"], smp["height"],
                                   smp["width"])
        least.append(sum(counts.blend_train_seconds(
            smp["P"], int(smp["counts"].sum()), smp["gidx"].shape[0], smp["height"],
            smp["width"], pairs).values()))
    per_view = sum(least) / len(least)
    return 100.0 * per_view * ctx["traced_steps"] * ctx["views_per_step"] / device_s
