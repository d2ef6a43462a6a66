"""exchange_ms: device milliseconds a step of the exchange between the
ranks: the NCCL kernels (found by name, ``nccl``) in rank 0's profiled
chunk, over its steps.  Each NCCL kernel runs until every rank has joined
the collective, so its time holds the wait for the slowest rank as well as
the transfer.  None where the trace holds no NCCL kernel (one card)."""

KERNEL = "nccl"


def read(ctx):
    device_s = sum(e - s for n, s, e in ctx["trace"].kernels if KERNEL in n.lower())
    if device_s <= 0:
        return None
    return 1e3 * device_s / ctx["traced_steps"]
