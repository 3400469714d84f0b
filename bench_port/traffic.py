"""The one reader of every traffic mix.

A mix is a file of parameters (``traffic/<name>.json``). Its one key so
far, ``loop``, says how frames are handed over; ``"closed"`` is the only
loop: each frame is handed over when the previous ``process_frame``
returned, through ``run_tum``'s synchronous engine (mapping passes on the
tracking thread), as a recorded sequence is read as fast as the engine
takes it.

Frames are the configuration's camera frames, one camera period of motion
apart, whatever the rate they are handed over at.
"""

from __future__ import annotations

LOOPS = ("closed",)


def read(mix: dict) -> dict:
    """The mix's parameters, checked."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"loop {mix.get('loop')!r}: one of {LOOPS}")
    unknown = set(mix) - {"loop"}
    if unknown:
        raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
    return dict(mix)
