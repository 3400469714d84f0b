"""MapMaker and BA on a flight over new ground: device time of the work
launched inside ``MapMaker.step`` per second of the traced stretch, the
route's last ``TRACE_SECONDS``, over a map near its full size. Read as its
offline namesake reads it."""

import runpy
from pathlib import Path

read = runpy.run_path(
    str(Path(__file__).with_name("map_device_ms_per_s.offline.py")))["read"]
