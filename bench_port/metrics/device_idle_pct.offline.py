"""The device: the share of the traced window that no kernel, copy or fill
on any stream covers (the union of their intervals)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
