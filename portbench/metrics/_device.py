"""What the trace-based readers share."""


def dispatches(trace):
    """Served dispatches inside the traced window: the CUDA graph launches
    the trace holds, or the replay counter's change across it."""
    return trace.graph_launches or trace.counts.get("replays", 0)


def idle_share(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
