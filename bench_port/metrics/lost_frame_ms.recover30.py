"""The engine: the mean host time of ``process_frame`` (the benchmark's
spans) over the frames that ``recovery_frames.recover30`` counts, of the
events that lie wholly outside the traced stretch (the profiler slows the
frames it traces). With it, ``recovery_frames.recover30`` splits
``recovery_ms``."""


def read(ctx):
    frames = ctx["spans"].of("process_frame")
    if ctx["trace_ns"] is None or not frames:
        return None
    w0, w1 = ctx["trace_ns"]
    n0 = ctx["n_setup"]
    times = []
    for e in ctx["events"]:
        if e["status"] != "recovered":
            continue
        spans = frames[n0 + e["first"]: n0 + e["reported"] + 1]
        if all(t1 < w0 or t0 > w1 for _, t0, t1 in spans):
            times += [t1 - t0 for _, t0, t1 in spans]
    if not times:
        return None
    return sum(times) / len(times) / 1e6
