"""The MapMaker's keyframe latency on a flight over new ground: host time
from the return of a frame that queued a keyframe to the return of the
frame whose mapping pass landed its integration (``MapMaker.step``
returned its slot: its new points are in the map), the median over the
window's keyframes that landed in it."""

import statistics


def read(ctx):
    t = ctx["returned"]
    lags = [t[c] - t[a] for a, c in ctx["keyframes"] or ()
            if c is not None]
    if not lags:
        return None
    return statistics.median(lags) * 1e3
