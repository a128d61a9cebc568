"""Images embedded and added to the index over the whole window, per
second of it (the closing ``add`` included)."""


def read(ctx):
    w = ctx.window
    return w.counts["images"] / w.window_s if w.window_s > 0 else None
