"""The one reader of every traffic mix.

A mix is a file of parameters (``traffic/<name>.json``):

- ``loop`` says how frames are handed over; ``"closed"`` is the only loop:
  each frame is handed over when the previous ``process_frame`` returned,
  through ``run_tum``'s synchronous engine (mapping passes on the tracking
  thread), as a recorded sequence is read as fast as the engine takes it.
- ``cover`` (optional): the lens covered by a hand or a cap, as a schedule
  over the window's handed-over frames. A cover starts ``first_frame``
  frames into the window and every ``every_frames`` frames after it, and
  lasts a whole number of frames drawn uniformly from the range
  ``frames`` ([lower, upper]) by a generator seeded from the run's seed.
  A covered frame is all black; the camera moves on under it.
- ``limits`` (optional): the limits of the checks that only this mix
  produces, merged with the configuration's (``Spec.limits``).

Frames are the configuration's camera frames, one camera period of motion
apart, whatever the rate they are handed over at. A later mix adds its
parameter here, to this one reader.
"""

from __future__ import annotations

import numpy as np

LOOPS = ("closed",)
KEYS = ("loop", "cover", "limits")
COVER_KEYS = ("every_frames", "frames", "first_frame")
#: Mixed into the seed of the cover's lengths, so that they are drawn from
#: a stream of their own.
COVER_STREAM = 0x636F766572


def _positive_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v > 0


def read(mix: dict) -> dict:
    """The mix's parameters, checked."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"loop {mix.get('loop')!r}: one of {LOOPS}")
    unknown = set(mix) - set(KEYS)
    if unknown:
        raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
    if "cover" in mix:
        _check_cover(mix["cover"])
    limits = mix.get("limits", {})
    if not isinstance(limits, dict) or not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            and v >= 0 for v in limits.values()):
        raise ValueError(f"limits {limits!r}: names to numbers >= 0")
    return dict(mix)


def _check_cover(cover) -> None:
    if not isinstance(cover, dict) or set(cover) != set(COVER_KEYS):
        raise ValueError(f"cover {cover!r}: exactly the keys {COVER_KEYS}")
    span = cover["frames"]
    if not (isinstance(span, list) and len(span) == 2
            and all(_positive_int(v) for v in span) and span[0] <= span[1]):
        raise ValueError(f"cover frames {span!r}: [lower, upper], positive "
                         f"integers, lower <= upper")
    for k in ("every_frames", "first_frame"):
        if not _positive_int(cover[k]):
            raise ValueError(f"cover {k} {cover[k]!r}: a positive integer")
    if cover["every_frames"] <= span[1]:
        raise ValueError(f"cover every_frames {cover['every_frames']} must "
                         f"exceed the longest cover, {span[1]}")


class Covers:
    """A mix's covers over one window: which handed-over frame ``n``
    (counted from the window's first) is covered. Without a ``cover``
    nothing is."""

    def __init__(self, cover: dict | None, seed: int):
        self.cover = cover
        self._lengths = []
        if cover is not None:
            self._rng = np.random.default_rng([int(seed) & (2**64 - 1),
                                               COVER_STREAM])

    def length(self, i: int) -> int:
        """Frames the ``i``-th cover lasts."""
        lo, hi = self.cover["frames"]
        while len(self._lengths) <= i:
            self._lengths.append(int(self._rng.integers(lo, hi + 1)))
        return self._lengths[i]

    def start(self, i: int) -> int:
        return self.cover["first_frame"] + i * self.cover["every_frames"]

    def at(self, n: int):
        """(the index of the cover whose span holds frame ``n``, or of the
        last that started before it (-1: none), and whether ``n`` is
        covered)."""
        if self.cover is None or n < self.cover["first_frame"]:
            return -1, False
        i = (n - self.cover["first_frame"]) // self.cover["every_frames"]
        return i, n < self.start(i) + self.length(i)
