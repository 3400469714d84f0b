"""The device layer's context: frames returned per second inside the
traced window. Read beside ``device_idle_pct.offline``: the profiler's own
cost (it records every kernel) slows the frames it traces, and the gap to
``frames_per_s`` shows by how much."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames_returned"] or not tr["window_s"]:
        return None
    return tr["frames_returned"] / tr["window_s"]
