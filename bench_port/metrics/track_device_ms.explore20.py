"""The tracking program on a flight over new ground: device time of the
tracking layer's work (every activity not launched inside
``MapMaker.step``) per tracked frame of the traced stretch. Read as its
offline namesake reads it."""

import runpy
from pathlib import Path

read = runpy.run_path(
    str(Path(__file__).with_name("track_device_ms.offline.py")))["read"]
