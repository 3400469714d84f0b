"""The relocalizer: frames handed over from the first after a cover to the
one that reports the recovery (the frame after the recovered one: the
engine reports a frame's quality with the next), the median over the
window's events that recovered. A count of the algorithm's attempts,
whatever their speed."""

import statistics


def read(ctx):
    done = [e for e in ctx["events"] if e["status"] == "recovered"]
    if not done:
        return None
    return statistics.median(e["reported"] - e["first"] + 1 for e in done)
