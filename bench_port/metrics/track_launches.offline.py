"""The kernels: kernels of the tracking layer launched per tracked frame of
the traced window (a CUDA graph's kernels each count)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames"]:
        return None
    return tr["track_kernels"] / tr["frames"]
