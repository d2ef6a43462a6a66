"""kernels_per_step: device kernels that ``torch.profiler`` recorded in the
profiled chunk, over its steps: the per-step cost of many small kernels
that sets the pace of the sparse phase."""


def read(ctx):
    kernels = ctx["trace"].kernels
    if not kernels:
        return None
    return len(kernels) / ctx["traced_steps"]
