"""Runtime command console (port of ``ptam_cg_tpu.io.commands``): the
headless counterpart of the reference's GUI command registry and live
GVars tweaks (GUI.ParseLine lines in config/settings.cfg, the commands
registered at src/main.cc:21-23 and src/GLWindow2.cc:15-323; the console
of doc/PTAM.txt:205-217).

- Verbs act on the engine: ``Reset``, ``PokeTracker`` / ``SpacePressed``,
  ``SaveMap [path]``, ``DumpMap [prefix]``, ``ShowInfo``, ``Get NAME``;
  ``DrawMap``, ``DrawAR`` and ``GLWindow`` are no-ops (render offline with
  ``viz/mapviewer.py`` and ``viz/ar.py``).
- ``Section.Name=value`` sets one of the tunables the engine reads on the
  host as it runs (``_tunables``); any other name is rejected, unlike
  GVars, which sets a variable nothing reads. ``Engine.DecisionInterval``,
  a tunable of the JAX engine, is rejected too: the port's engine reads
  each tracked frame's decisions at the next frame, always, and has no
  decision interval (see ``models/engine.py``).
- A command file drives a run as the reference's GUI.ParseLine block
  does; a line may start with ``@N`` to run at frame N.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


class CommandError(ValueError):
    pass


def _tunables(eng) -> Dict[str, Tuple[Callable, Callable, str]]:
    """name -> (getter, setter, doc); each setter changes state the
    engine or its MapMaker reads on the host as it runs."""
    mm = eng.mapmaker

    def set_cfg(section, **kw):
        eng.cfg = eng.cfg.replace(**{section: dataclasses.replace(
            getattr(eng.cfg, section), **kw)})

    return {
        "Tracker.MinFramesBetweenKFs": (
            lambda: eng.cfg.tracker.min_frames_between_kfs,
            lambda v: set_cfg("tracker", min_frames_between_kfs=int(v)),
            "keyframe cadence floor (Tracker.cc:152)"),
        "MapMaker.MaxQueueSize": (
            lambda: eng.cfg.mapmaker.max_queue_size,
            lambda v: set_cfg("mapmaker", max_queue_size=int(v)),
            "pending-keyframe queue bound"),
        "Bundle.MaxIterations": (
            lambda: mm.ba_cfg.max_iterations,
            lambda v: setattr(mm, "ba_cfg", dataclasses.replace(
                mm.ba_cfg, max_iterations=int(v))),
            "LM iteration budget of a BA run (Bundle.cc:40)"),
        "Bundle.TierFloorMeas": (
            lambda: mm._tier_m_floor,
            lambda v: setattr(mm, "_tier_m_floor", int(v)),
            "pin the BA measurement tier"),
        "Bundle.TierFloorCams": (
            lambda: mm._tier_c_floor,
            lambda v: setattr(mm, "_tier_c_floor", int(v)),
            "pin the BA camera tier"),
        "Bundle.TierFloorPoints": (
            lambda: mm._tier_p_floor,
            lambda v: setattr(mm, "_tier_p_floor", int(v)),
            "pin the BA point tier"),
    }


class CommandConsole:
    """Execute reference-console-style commands against a live engine."""

    def __init__(self, engine):
        self.eng = engine
        self.log: List[str] = []

    def execute(self, line: str) -> Optional[str]:
        """Run one command line; returns a human-readable result (also
        appended to ``log``), or raises CommandError."""
        line = line.split("//")[0].strip()
        if not line:
            return None
        out = self._dispatch(line)
        if out:
            self.log.append(out)
        return out

    def _dispatch(self, line: str) -> str:
        eng = self.eng
        if "=" in line and " " not in line.split("=")[0]:
            name, _, val = line.partition("=")
            name, val = name.strip(), val.strip()
            if name == "Engine.DecisionInterval":
                raise CommandError(
                    f"{name}: the port's engine reads each tracked frame's "
                    f"decisions at the next frame and has no decision "
                    f"interval")
            table = _tunables(eng)
            if name not in table:
                raise CommandError(
                    f"unknown or compile-baked tunable '{name}' "
                    f"(runtime-adjustable: {sorted(table)})")
            table[name][1](float(val) if "." in val else int(val))
            return f"{name}={_tunables(eng)[name][0]()}"

        verb, *args = line.split()
        if verb == "Reset":
            eng.reset()
            return "map ditched, tracker reset"
        if verb in ("PokeTracker", "SpacePressed"):
            eng.request_init()
            return "init requested"
        if verb == "SaveMap":
            from ptam_cg_tpu_torch.io import checkpoint
            path = args[0] if args else "map_checkpoint.npz"
            checkpoint.save_map(path, eng.snapshot(),
                                tracker_state=eng.tracker_state)
            return f"map saved -> {path}"
        if verb == "DumpMap":
            from ptam_cg_tpu_torch.io import checkpoint
            prefix = args[0] if args else "map_dump"
            checkpoint.export_map_text(prefix, eng.snapshot())
            return f"map dumped -> {prefix}*"
        if verb == "ShowInfo":
            return (f"stage={eng.stage.name} kfs={eng.mapmaker.n_kfs()} "
                    f"pts={eng._n_points_host} "
                    f"quality={eng._last_quality}")
        if verb == "Get":
            table = _tunables(eng)
            if not args or args[0] not in table:
                raise CommandError(f"Get: expected one of {sorted(table)}")
            return f"{args[0]}={table[args[0]][0]()}"
        if verb in ("DrawMap", "DrawAR", "GLWindow"):
            return (f"{verb}: no-op (headless build; render offline via "
                    f"viz/mapviewer.py / viz/ar.py)")
        raise CommandError(f"unknown command '{verb}'")


def load_command_script(path: str) -> List[Tuple[int, str]]:
    """Parse a command file into [(frame, line)], sorted by frame: a line
    runs at frame 0 unless it starts with ``@N``."""
    out: List[Tuple[int, str]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("//")[0].strip()
            if not line:
                continue
            frame = 0
            if line.startswith("@"):
                tok, _, rest = line.partition(" ")
                frame = int(tok[1:])
                line = rest.strip()
            out.append((frame, line))
    return sorted(out, key=lambda x: x[0])


class ScriptedConsole:
    """Runs a command script's lines as the frames they name come."""

    def __init__(self, engine, script: List[Tuple[int, str]]):
        self.console = CommandConsole(engine)
        self.script = list(script)
        self._next = 0

    def on_frame(self, frame_idx: int) -> List[str]:
        ran = []
        while (self._next < len(self.script)
               and self.script[self._next][0] <= frame_idx):
            _, line = self.script[self._next]
            self._next += 1
            res = self.console.execute(line)
            if res:
                ran.append(res)
        return ran
