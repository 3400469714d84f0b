"""Closed loop: frames returned in the window over the window, which one
device sync closes."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ctx["frames"] / ctx["window_s"]
