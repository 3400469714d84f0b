"""MapMaker and BA: device time of the work launched inside
``MapMaker.step`` per second of the traced window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return tr["map_s"] * 1e3 / tr["window_s"]
