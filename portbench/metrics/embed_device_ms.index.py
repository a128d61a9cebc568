"""Device-busy milliseconds per embedded batch, from the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.counts.get("batches"):
        return None
    return t.busy_s * 1e3 / t.counts["batches"]
