"""Share of the MSM kernels' device time that the least time of their work
is (metrics/roofline.py), in percent."""
from metrics.roofline import share


def read(ctx):
    return share(ctx)
