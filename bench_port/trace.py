"""Spans the benchmark puts around the program's entry points, and the
reduction of a ``torch.profiler`` trace of the card.

Spans are (name, start ns, end ns) on ``time.time_ns``'s clock, which is
the clock of the profiler's events. The trace gives each device activity
(kernel, copy, fill) with the correlation of the host call that launched it
(a kernel launch, a graph launch, a copy); that call's time places the
activity in a span: a kernel whose launch falls inside a ``MapMaker.step``
span is the mapping layer's, every other one the tracking layer's; one
inside a ``RelocProgram`` span is also the relocalizer's.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass

STEP = "MapMaker.step"
FRAME = "process_frame"
RELOC = "RelocProgram"


class Spans:
    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def wrap(self, patches, owner, attr: str, name: str) -> None:
        """Record a span around every call of ``owner.attr`` (replaced
        through ``patches``, a ``cell.Patches``)."""
        def make(fn):
            def spanned(*a, **kw):
                t0 = time.time_ns()
                try:
                    return fn(*a, **kw)
                finally:
                    self.add(name, t0, time.time_ns())
            return spanned
        patches.wrap(owner, attr, make)

    def of(self, name: str):
        with self._lock:
            return [s for s in self.items if s[0] == name]

    def seconds_in(self, name: str, w0: int, w1: int) -> float:
        """Seconds of ``name`` spans inside [w0, w1] (ns)."""
        return sum(max(0, min(t1, w1) - max(t0, w0))
                   for _, t0, t1 in self.of(name)) / 1e9


@dataclass
class Activity:
    name: str
    start: int            # ns, the profiler's clock
    end: int
    kernel: bool          # a kernel (not a copy or a fill)
    launch_t: int | None  # the launching host call's start, ns


@dataclass
class Trace:
    """A traced window [w0, w1] (ns) and its device activities."""
    w0: int
    w1: int
    acts: list

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9


RUNTIME_PREFIXES = ("cuda", "cu")


def read_profile(prof, w0: int, w1: int) -> Trace:
    """The device activities of a stopped ``torch.profiler.profile`` that
    start inside [w0, w1], each with its launching call's time."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    launches, device = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.name().startswith(RUNTIME_PREFIXES):
            launches[e.correlation_id()] = e.start_ns()
    acts = []
    for e in device:
        t0 = e.start_ns()
        if not w0 <= t0 <= w1:
            continue
        name = e.name()
        acts.append(Activity(
            name=name, start=t0, end=t0 + e.duration_ns(),
            kernel=not name.startswith(("Memcpy", "Memset", "memcpy",
                                        "memset")),
            launch_t=launches.get(e.correlation_id())))
    return Trace(w0, w1, acts)


def launched_in(trace: Trace, spans: Spans, name: str):
    """Split the activities into (inside, outside): inside when the host
    call that launched it started inside a ``name`` span. Spans are matched
    by time alone, which is exact where one thread launches everything, as
    the synchronous engine does. Returns also how many activities had no
    launching call found (counted outside)."""
    iv = sorted((t0, t1) for _, t0, t1 in spans.of(name))
    starts = [a for a, _ in iv]
    inside, outside, unplaced = [], [], 0
    for a in trace.acts:
        hit = False
        if a.launch_t is None:
            unplaced += 1
        else:
            i = bisect.bisect_right(starts, a.launch_t) - 1
            hit = i >= 0 and a.launch_t <= iv[i][1]
        (inside if hit else outside).append(a)
    return inside, outside, unplaced


def attribute(trace: Trace, spans: Spans):
    """Split the activities into (tracking, mapping): mapping when it was
    launched inside a ``MapMaker.step`` span (``launched_in``). Returns
    also how many activities had no launching call found."""
    mapping, track, unplaced = launched_in(trace, spans, STEP)
    return track, mapping, unplaced


def union_seconds(acts, w0: int, w1: int):
    """(busy seconds, the idle gaps [(start, end)] ns) of the union of the
    activities' intervals (every stream), clipped to [w0, w1]."""
    iv = sorted((max(a.start, w0), min(a.end, w1)) for a in acts
                if a.end > w0 and a.start < w1)
    busy, gaps, cur = 0, [], w0
    run_s = run_e = None
    for s, e in iv:
        if run_e is None or s > run_e:
            if run_e is not None:
                busy += run_e - run_s
            gaps.append((cur if run_e is None else run_e, s))
            run_s, run_e = s, e
        else:
            run_e = max(run_e, e)
    if run_e is not None:
        busy += run_e - run_s
        gaps.append((run_e, w1))
    else:
        gaps.append((w0, w1))
    return busy / 1e9, [(a, b) for a, b in gaps if b > a]


def label(t: int, spans: Spans) -> str:
    """What the host was doing at ``t``: inside a mapping pass, inside a
    relocalizer's call, inside a frame, or neither."""
    for name in (STEP, RELOC, FRAME):
        if any(t0 <= t <= t1 for _, t0, t1 in spans.of(name)):
            return name
    return "none"


def breakdown(trace: Trace, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by what the host was doing when it began."""
    by_name = {}
    for a in trace.acts:
        by_name[a.name] = by_name.get(a.name, 0) + (a.end - a.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = union_seconds(trace.acts, trace.w0, trace.w1)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": [[f"{label(g0, spans)}@{(g0 - trace.w0) / 1e6:.3f}ms",
                           (g1 - g0) / 1e9] for g0, g1 in gaps]}
