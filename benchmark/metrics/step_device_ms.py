"""step_device_ms: device milliseconds a step, from CUDA events recorded
around each chunk call of the traced run's window (all but the profiled
chunk), over the chunk's steps: the chunk and step layer's own time
(``engine/train.py::run_chunk`` replaying the captured step)."""


def read(ctx):
    ms = ctx["chunk_ms"]
    if not ms:
        return None
    return sum(ms) / (len(ms) * ctx["chunk_steps"])
