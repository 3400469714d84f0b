"""The relocalizer program: device time of the work launched inside
``RelocProgram``'s calls (the benchmark's spans around them) per call in
the traced stretch, from the profiler."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["reloc_calls"] or not tr["reloc_s"]:
        return None
    return tr["reloc_s"] / tr["reloc_calls"] * 1e3
