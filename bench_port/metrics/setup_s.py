"""Set-up: from the process's start to the first timed frame (imports,
kernel builds, rendering, the map-building sweeps and every capture)."""


def read(ctx):
    return ctx["setup_s"]
