"""Queries answered by ``FlatIndex.search`` over the whole window, per
second of it (the upload, any certificate retry and the copy back
included)."""


def read(ctx):
    w = ctx.window
    return w.counts["queries"] / w.window_s if w.window_s > 0 else None
