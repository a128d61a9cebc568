"""Requests answered per served dispatch (a CUDA graph replay) over the
window: how full the micro-batcher's batches ride."""


def read(ctx):
    c = ctx.window.counts
    return c["requests"] / c["replays"] if c.get("replays") else None
