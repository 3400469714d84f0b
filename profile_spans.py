"""The span recorder (``ptam_cg_tpu_torch/utils/spans.py``) on the
benchmark's cell: its readings, and what it costs when on.

    python3 profile_spans.py [--workload NAME] [--seeds N ...]
        [--seconds S] [--cost] [--out FILE]

For each seed, on the card, one run of the cell (``bench_port/cell.py``)
with the recorder switched on before the engine is built (so the
set-up's captures carry the tracking program's stage markers) and the
window traced as ``--trace 1`` traces it. Printed: ``spans.reduce`` over
the unprofiled stretch (from the window's start to the profiler's start:
the profiler's cost is not in it), the set-up's warm-up and capture
seconds, and the run's seven per-layer metrics as the benchmark reads
them. Read the unprofiled ``frames_per_s`` beside untraced runs of the
benchmark on the same seeds, each in a process of its own.

With ``--cost``, first, once, on an engine taken through the cell's
set-up with the recorder on: ``FRAMES`` frames under a fresh ``torch.profiler``
(each tracking replay's markers beside its kernels: where the end marker
lies from the last activity's end and the first kernel from the first
marker, and the kernels and their device time by stage); the tracking
graph (with markers) and the same program captured with the recorder
off, replayed ``--replays`` times each, in turns, timed by CUDA events;
and the host nanoseconds the recorder's calls take a frame (a tracked
frame's spans, one reading and its anchor), on against off. Prints one
JSON object a line; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import cell as celllib  # noqa: E402
from bench_port import scene  # noqa: E402
from bench_port.spec import Spec  # noqa: E402
from ptam_cg_tpu_torch.utils import spans  # noqa: E402

#: Frames traced by the profiler in ``--cost``.
FRAMES = 100


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def _us(values) -> dict:
    if not values:
        return dict(n=0)
    return dict(n=len(values),
                within_100us=sum(abs(v) <= 100_000 for v in values),
                median=statistics.median(values) / 1e3,
                min=min(values) / 1e3, max=max(values) / 1e3)


def readings(spec, name: str, seed: int, seconds: float) -> dict:
    spans.clear()
    spans.enable()
    try:
        out = celllib.run(spec, name, seed, seconds, True, "cuda",
                          time.perf_counter())
        exp = spans.export()
    finally:
        spans.disable()
        spans.clear()
    ctx = out.ctx
    tw0, tw1 = ctx["window_ns"]
    # With no device activity traced, the whole window is unprofiled.
    w0 = ctx["trace"]["trace"].w0 if ctx["trace"] is not None else tw1
    limits = spec.config(spec.cell(name)["config"])["limits"]
    return dict(
        seed=seed, correct=all(out.checks[k] <= v for k, v in limits.items()),
        frames_per_s_window=ctx["frames"] / ctx["window_s"],
        unprofiled_s=(w0 - tw0) / 1e9, unprofiled=spans.reduce(exp, tw0, w0),
        setup_capture_s=spans.reduce(exp, 0, tw0)["capture_s"],
        setup_s=ctx["setup_s"],
        per_layer={m["name"]: spec.reader(m["name"])(ctx)
                   for m in spec.metrics(name, True)},
        notes=out.notes)


def profiled(eng, frames) -> dict:
    """``frames`` under a fresh profiler: the markers beside the kernels."""
    from torch.profiler import ProfilerActivity, profile
    spans.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for im in frames:
            eng.process_frame(im)
        torch.cuda.synchronize()
    exp = spans.export()
    pairs = spans.profiled_replays(exp, prof)
    n = max(len(pairs), 1)
    return dict(
        replays=len(pairs), readings=len(exp["stages"]),
        end_marker_after_last_activity_us=_us(
            [r["marks"][-1][1] - max(e for _, e, _ in acts)
             for r, acts in pairs]),
        first_kernel_after_first_marker_us=_us(
            [min(a for a, _, name in acts
                 if not name.startswith(spans.NOT_KERNELS))
             - r["marks"][0][1] for r, acts in pairs]),
        kernels_placed=sum(spans.placed(pairs)),
        by_stage={k: dict(kernels=c / n, ms=ns / n / 1e6)
                  for k, (c, ns) in spans.by_stage(pairs).items()})


def _replay_ms(prog, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        prog.graph.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _host_ns(marks, n: int) -> float:
    """ns a frame of the recorder's calls takes: a tracked frame's six
    spans, a reading of ``marks`` and the anchor."""
    t = time.perf_counter_ns()
    for k in range(n):
        with spans.span("process_frame", k) as s:
            with spans.span("engine.read_info"):
                pass
            spans.synced()
            with spans.span("engine.draws"):
                pass
            with spans.span("track.fill"):
                pass
            if spans.enabled:        # as ``TrackProgram.run``
                spans.before_replay(marks)
            with spans.span("track.replay"):
                pass
            spans.replayed(marks)
            with spans.span("mapmaker.step"):
                pass
            s.note("TRACKING")
    return (time.perf_counter_ns() - t) / n


def cost(spec, name: str, seed: int, n_replays: int) -> dict:
    cfg = spec.config(spec.cell(name)["config"])
    spans.clear()
    spans.enable()
    seq = scene.Sequence(cfg, seed, "cuda")
    eng = celllib.make_engine(cfg, seed, "cuda")
    try:
        k = seq.path.ramp + 4 * 2 * seq.path.n_sweep
        for i in range(k):
            eng.process_frame(seq.frame(i))
        prof = profiled(eng, [seq.frame(i) for i in range(k, k + FRAMES)])
        marked = eng._programs["track"]
        spans.disable()
        del eng._programs["track"]
        eng.process_frame(seq.frame(k + FRAMES))
        plain = eng._programs["track"]
        assert marked.marks is not None and plain.marks is None
        for prog in (marked, plain):          # the clocks settle
            _replay_ms(prog, n_replays)
        ms = {"markers": [], "none": []}
        for _ in range(3):
            for prog, key in ((marked, "markers"), (plain, "none"),
                              (plain, "none"), (marked, "markers")):
                ms[key].append(_replay_ms(prog, n_replays))
        # The marks' events have run: a reading of them costs what a
        # frame's does.
        host = {"off": [], "on": []}
        for on in (False, True, True, False, False, True):
            spans.enable() if on else spans.disable()
            spans.clear()
            host["on" if on else "off"].append(_host_ns(marked.marks,
                                                        20_000))
    finally:
        spans.disable()
        spans.clear()
        eng.close()
    return dict(profiled=prof, replays=n_replays, replay_ms=ms,
                host_ns_a_frame=host, markers=len(marked.marks.labels))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tum_fr1_desk.offline")
    ap.add_argument("--seeds", type=int, nargs="+", default=[4200000001])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--replays", type=int, default=1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_spans.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = Spec(ROOT)
    lines = [dict(card=card(), torch=torch.__version__)]
    print(json.dumps(lines[-1]), flush=True)
    if args.cost:
        # First: its profiler is the process's first.
        lines.append(dict(kind="cost", **cost(spec, args.workload,
                                              args.seeds[0], args.replays)))
        print(json.dumps(lines[-1]), flush=True)
    for seed in args.seeds:
        lines.append(dict(kind="readings", **readings(
            spec, args.workload, seed, args.seconds)))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
