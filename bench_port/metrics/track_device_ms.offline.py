"""The tracking program: device time of the tracking layer's work (every
activity not launched inside ``MapMaker.step``) per tracked frame of the
traced window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames"] or not tr["track_s"]:
        return None
    return tr["track_s"] / tr["frames"] * 1e3
