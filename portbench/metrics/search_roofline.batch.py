"""The search's least time over its device-busy time per search, from the
trace: the least time is the larger of 2 Q N d operations at the bf16 rate
and the store, norms, queries and answers moved once (``bounds.
search_bound_ms``), whatever kernels do the work."""

from portbench.reference import bounds

ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def read(ctx):
    t = ctx.trace
    if t is None or not t.counts.get("searches") or t.busy_s <= 0:
        return None
    cfg, mix = ctx.config, ctx.mix
    least = bounds.search_bound_ms(mix["queries_per_call"], cfg["rows"], cfg["dim"], mix["k"],
                                   ITEMSIZE[cfg["store_dtype"]])
    return 100.0 * least / (t.busy_s * 1e3 / t.counts["searches"])
