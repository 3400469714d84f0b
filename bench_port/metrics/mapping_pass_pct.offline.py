"""The engine layer, synchronous: the share of the window (host clock)
spent inside ``MapMaker.step`` on the tracking thread."""


def read(ctx):
    w0, w1 = ctx["window_ns"]
    return 100.0 * ctx["spans"].seconds_in("MapMaker.step", w0, w1) / (
        (w1 - w0) / 1e9)
