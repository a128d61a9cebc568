"""Device-busy milliseconds per served dispatch (one CUDA graph replay:
the upload, the embed and the search core), from the trace."""

from portbench.metrics._device import dispatches


def read(ctx):
    t = ctx.trace
    if t is None or not dispatches(t):
        return None
    return t.busy_s * 1e3 / dispatches(t)
