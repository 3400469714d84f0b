"""The benchmark of ptam_cg_tpu_torch on the card: one run of one cell.

    python3 bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``
(the window's frames, less those covered and those of an event the
window's end cut), ``failed`` (those the engine reported lost or not
tracking, and those after a cover before its recovery), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; and last
``checks``, each number that decides ``correct`` beside its limit, which
also end standard error. Exits non-zero with no result when no card (or too
few) is present, when the run fails (its traceback on standard error), or
when a module of JAX or of the JAX package was loaded by the time the
result is built.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: Top-level module names no run may load: JAX and the JAX package, whose
#: name the port's own begins with (so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "ptam_cg_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                         else modules)}
    return sorted(names & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics(spec, cell: str, trace: bool, ctx: dict) -> dict:
    """Each metric the cell reports that its reader finds, by name."""
    out = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(spec, args, outcome, limits: dict, device: dict) -> dict:
    """The result's line. A check the run did not produce, or produced as
    no finite number, has the value null and makes the run not correct."""
    checks = {}
    for k, limit in limits.items():
        v = outcome.checks.get(k)
        checks[k] = {"value": float(v) if v is not None and math.isfinite(v)
                     else None, "limit": float(limit)}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    # Covered frames are not attempted; those lost after a cover fail.
    failed = sum(1 for i, counted, lost in zip(outcome.infos, outcome.counted,
                                               outcome.lost)
                 if counted and (lost or i.stage != "TRACKING"
                                 or i.quality == 0))
    res = {"correct": correct, "attempted": int(sum(outcome.counted)),
           "failed": failed,
           "metrics": metrics(spec, args.workload, bool(args.trace),
                              outcome.ctx),
           "device": device}
    tr = outcome.ctx["trace"]
    if args.trace and tr is not None:
        res["breakdown"] = tr["breakdown"]
    res["checks"] = checks
    return res


def report(spec, args, outcome, device: dict) -> int:
    """Build the result (loading every metric's reader), print the notes
    and the numbers compared to standard error, then, unless a module of
    JAX or of the JAX package has been loaded by then (exit 3, no result),
    the result's line to standard output."""
    limits = spec.limits(args.workload)
    res = result(spec, args, outcome, limits, device)
    for line in outcome.notes + [f"card: {power_limit()}"]:
        print(line, file=sys.stderr)
    for k, v in outcome.checks.items():
        if k not in limits:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in res["checks"].items():
        got = outcome.checks.get(k, "missing")
        print(f"check {k} {got if c['value'] is None else c['value']!r} "
              f"limit {c['limit']!r}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from bench_port import cell as celllib
    from bench_port.spec import Spec

    spec = Spec(ROOT)
    wl = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    try:
        out = celllib.run(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    except Exception:
        traceback.print_exc()
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"], "memory_peak_bytes": out.memory_peak}
    tr = out.ctx["trace"]
    if args.trace and tr is not None:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    return report(spec, args, out, device)


if __name__ == "__main__":
    sys.exit(main())
