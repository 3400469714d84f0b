"""What the benchmark runs, found by name from its own files.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. Each configuration is the JSON file its
entry names, with the limits of ``correct``; each traffic mix is
``traffic/<name>.json``, with the limits of its own checks; each metric is a
reader ``metrics/<name>.py`` with a function ``read(ctx)`` that returns a
number or None. A later cell, mix or metric is a new file and a new entry:
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """``root``: the checkout (``BENCHMARK.json``'s directory); ``here``:
    the benchmark's folder, which holds ``traffic/`` and ``metrics/``."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers = {}

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        """The limits of the numbers that decide a cell's ``correct``: its
        configuration's, and its mix's for the checks that only the mix
        produces (a mix may not restate a configuration's)."""
        w = self.cell(cell)
        base = self.config(w["config"])["limits"]
        extra = self.traffic(w["traffic"]).get("limits", {})
        if set(base) & set(extra):
            raise ValueError(f"traffic {w['traffic']!r} restates limits "
                             f"{sorted(set(base) & set(extra))}")
        return {**base, **extra}

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: with ``trace`` the per-layer
        ones, else the end-to-end ones; an entry with ``workloads`` only in
        the cells it lists, one without in every cell that reports the
        end-to-end metric it moves (every cell, for an end-to-end one)."""
        if not trace:
            return [m for m in self.doc["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        e2e = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, name: str):
        """``metrics/<name>.py``'s ``read``."""
        if name not in self._readers:
            path = self.here / "metrics" / f"{name}.py"
            mod_name = "bench_port.metrics." + name.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]
