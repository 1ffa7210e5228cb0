"""95th percentile (nearest rank) of every verification's latency in the
traced window, in seconds."""
import math


def read(ctx):
    if not ctx.latencies:
        return None
    ordered = sorted(ctx.latencies)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
