"""The engine layer, synchronous, on a flight over new ground: the share
of the window (host clock) spent inside ``MapMaker.step`` on the tracking
thread, where keyframes are integrated and BA runs. Read as its offline
namesake reads it."""

import runpy
from pathlib import Path

read = runpy.run_path(
    str(Path(__file__).with_name("mapping_pass_pct.offline.py")))["read"]
