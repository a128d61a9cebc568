"""Group-min sweeps launched per search over the window (the kernel
wrappers' launch counters): 1.0 when no certificate retry re-ran one."""


def read(ctx):
    c = ctx.window.counts
    return c["groupmin_launches"] / c["searches"] if c.get("searches") else None
