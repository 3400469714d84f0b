"""The kernels: the least time a tracked frame's counted work needs
(``roofline.py``, from the shapes of its calls) over its tracking device
time, as a percentage."""


def read(ctx):
    tr = ctx["trace"]
    bound = ctx["recorder"].frame_bound_s()
    if tr is None or not tr["frames"] or not tr["track_s"] or not bound:
        return None
    return 100.0 * bound / (tr["track_s"] / tr["frames"])
