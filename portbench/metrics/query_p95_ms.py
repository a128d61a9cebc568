"""The 95th percentile (nearest rank) of every request's time from its due
time to its answer, over all requests of the window; a request that failed
counts as infinitely late."""

import math

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if lat is None or len(lat) == 0:
        return None
    ordered = np.sort(lat)
    return float(ordered[math.ceil(0.95 * len(ordered)) - 1]) * 1e3
