"""The port's span recorder: host spans at the engine's boundaries and
stage markers inside the tracking program's CUDA graph, all on the clock
``torch.profiler`` stamps its events with (``time.time_ns``).

It is off by default and process-wide. ``enable()`` turns it on, for
every thread; ``export()`` returns what it has recorded; ``clear()``
drops that. While it is off, a site is one call that reads the
module-level bool ``enabled`` and returns (a shared no-op context
manager, for ``span``): no clock call, no allocation, no CUDA event.

Host spans (``span(name)``, a context manager) carry their name, start
and end in ``time.time_ns()``, the frame they belong to (the engine's
``frame_idx``, taken from the ``process_frame`` span they sit in) and
their parent span (the innermost span open on the same thread). The
engine records:

======================  ==================================================
``process_frame``       the root, one a frame; ``stage``: the stage the
                        frame ended in
``engine.read_info``    the host blocked on the card: the wait for the
                        previous frame's info vector (on the card only)
``engine.keyframe``     the previous frame's keyframe, built and queued
``engine.draws``        the frame's coarse and fine uniforms
``track.fill``          the frame, state and 14 ``TrackView`` tables
                        copied into the tracking program's buffers
``track.replay``        the tracking graph's launch (on the CPU, the
                        eager call)
``mapmaker.step``       one pass of the mapping scheduler
                        (``MapMaker.step``, on either thread)
``graph.warm``,         a CUDA graph's warm-up, and its capture and
``graph.capture``       instantiation (``graphs.Graph``)
``spans.read``          the recorder reading the last replay's markers
                        (its own cost, on the card)
======================  ==================================================

Stage markers (``stage(label)``) split a program into stages. A program
captured while the recorder is on holds a timing CUDA event at each
boundary (``StageMarks``: event-record nodes of the graph); a program
captured while it is off holds none, and its replays give no reading.
On the CPU, and on the card with ``graphs=False``, each boundary takes a
host stamp instead. A replay's events are read after the caller has next
waited for the card (``synced``: the engine's ``_read_info``), before the
graph is replayed again, so reading them adds no sync. They are put on
the host clock through an anchor: an event recorded on the idle stream
right after the previous wait, before the replay, with a
``time.time_ns()`` reading beside it. It is recorded anew at every wait,
since the card's clock and the host's part by tens of microseconds a
second. Reading a replay costs 14 ``elapsed_time`` calls on the host, in
the device's gap between replays (PERF.md has the measured costs).

The tracking program's stages, in the order of their boundaries (the
coarse and the fine search each pass ``select`` to ``pose_gn``):
``STAGES``. ``reduce`` turns an export into per-frame means over an
interval; ``profiled_replays`` finds each replay's kernels in a
``torch.profiler`` trace and ``by_stage`` bins them into the stages.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time

import torch

#: Whether the recorder is on (``enable``/``disable``).
enabled = False

#: The tracking program's stages, in the order of their first boundary.
STAGES = ("frontend", "sbi_rotation", "select", "templates", "ssd_search",
          "subpix_refine", "pose_gn", "decide")
#: The label of a program's last boundary.
END = "end"
#: The stage each hand-written kernel of the tracking program runs in (K1,
#: K5, K2's two kernels, K4), by a part of its name: where a profiler
#: finds them tells whether the markers sit where they should.
KERNEL_STAGES = {"fast10_atlas_kernel": "frontend",
                 "sbi_esm_kernel": "sbi_rotation",
                 "gather_kernel": "templates",
                 "gather_pair_kernel": "ssd_search",
                 "pose_gn_kernel": "pose_gn"}
#: The spans ``reduce`` does not count as a frame's own host time: the
#: wait for the card, the mapping pass and the recorder's own reading.
WAITS = ("engine.read_info", "mapmaker.step", "spans.read")
#: The spans of CUDA graph set-up.
CAPTURES = ("graph.warm", "graph.capture")

_LOCAL = threading.local()
_LOCK = threading.Lock()
_ids = itertools.count()
_spans: list = []
#: Finished stage readings: (frame, [(label, ns), ...]).
_readings: list = []
#: Replays whose markers are not read yet: (thread id, frame, StageMarks,
#: the anchor recorded before the replay or None).
_pending: list = []


def enable() -> None:
    """Turn the recorder on, for every thread of the process."""
    global enabled
    enabled = True


def disable() -> None:
    """Turn it off. What it recorded stays until ``clear``, but for the
    replays not read yet, which the next replays would overwrite: call
    ``export`` first to keep them."""
    global enabled
    enabled = False
    with _LOCK:
        _pending.clear()


def clear() -> None:
    """Drop every span and reading."""
    with _LOCK:
        _spans.clear()
        _readings.clear()
        _pending.clear()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """A host span: ``with span(name) as s:``. ``note(stage=)`` sets its
    ``stage``."""

    __slots__ = ("id", "name", "t0", "t1", "frame", "parent", "stage")

    def __init__(self, name: str, frame: int | None = None):
        self.id, self.name, self.frame = next(_ids), name, frame
        self.parent = self.stage = None
        self.t0 = self.t1 = 0

    def _open(self) -> None:
        stack = _stack()
        if stack:
            outer = stack[-1]
            self.parent = outer.id
            if self.frame is None:
                self.frame = outer.frame

    def __enter__(self):
        self._open()
        _stack().append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        _stack().pop()
        _spans.append(self)
        return False

    def note(self, stage: str) -> None:
        self.stage = stage


class _Off:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, stage: str) -> None:
        pass


_OFF = _Off()


def span(name: str, frame: int | None = None):
    """A context manager that records a host span named ``name`` (a
    no-op while the recorder is off). ``frame``: the frame it belongs to;
    by default its parent's."""
    if not enabled:
        return _OFF
    return Span(name, frame)


def add(name: str, t0: int, t1: int) -> None:
    """Record a span that the caller timed itself (ns, ``time.time_ns``),
    inside the innermost span open on this thread."""
    if not enabled:
        return
    s = Span(name)
    s._open()
    s.t0, s.t1 = t0, t1
    _spans.append(s)


def _frame():
    stack = _stack()
    return stack[-1].frame if stack else None


class StageMarks:
    """The stage boundaries of a program: ``labels``, and beside each a
    timing CUDA event recorded into the graph under capture (``device``;
    one set for the graph, recorded again by each replay) or a host stamp
    (one ``StageMarks`` a call)."""

    __slots__ = ("device", "labels", "times")

    def __init__(self, device: bool):
        self.device, self.labels, self.times = device, [], []

    def mark(self, label: str) -> None:
        if self.device:
            if not torch.cuda.is_current_stream_capturing():
                return          # the warm-up before the capture
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            self.times.append(event)
        else:
            self.times.append(time.time_ns())
        self.labels.append(label)


@contextlib.contextmanager
def marking(marks: StageMarks | None):
    """Send this thread's ``stage`` calls to ``marks`` (None: nowhere)."""
    outer = getattr(_LOCAL, "marks", None)
    _LOCAL.marks = marks
    try:
        yield
    finally:
        _LOCAL.marks = outer


def stage(label: str) -> None:
    """A stage boundary: ``label`` starts here (``END``: the program
    ends)."""
    if not enabled:
        return
    marks = getattr(_LOCAL, "marks", None)
    if marks is not None:
        marks.mark(label)


def stamped(marks: StageMarks) -> None:
    """An eager call's host-stamped boundaries, as a reading."""
    if marks.labels:
        with _LOCK:
            _readings.append((_frame(), list(zip(marks.labels,
                                                 marks.times))))


def replayed(marks: StageMarks | None) -> None:
    """A graph holding ``marks`` was just launched on the current stream:
    its reading is taken at this thread's next ``synced`` (or
    ``before_replay``), through the anchor recorded before it."""
    if not enabled or marks is None or not marks.times:
        return
    with _LOCK:
        _pending.append((threading.get_ident(), _frame(), marks,
                         getattr(_LOCAL, "anchor", None)))


def _take(keep) -> list:
    with _LOCK:
        taken = [p for p in _pending if keep(p)]
        _pending[:] = [p for p in _pending if not keep(p)]
    return taken


def before_replay(marks: StageMarks | None) -> None:
    """Read the last replay of ``marks`` if nobody has waited for it yet
    (a wait for its last event): the next replay records its events
    again."""
    if marks is None:
        return
    mine = _take(lambda p: p[2] is marks)
    if mine:
        marks.times[-1].synchronize()
        _read(mine)


def synced() -> None:
    """The caller has just waited for the current stream, which is idle:
    read this thread's replays not read yet, then record the anchor anew
    for the next ones, inside a ``spans.read`` span (the recorder's own
    cost). Nothing while the recorder is off."""
    if not enabled:
        return
    me = threading.get_ident()
    with span("spans.read"):
        _read(_take(lambda p: p[0] == me))
        event, _ = getattr(_LOCAL, "anchor", None) or (
            torch.cuda.Event(enable_timing=True), 0)
        event.record()
        _LOCAL.anchor = (event, time.time_ns())


def _read(pending) -> None:
    """The replays' readings: each event's time on the host clock, from
    the anchor recorded before the replay (its ``time.time_ns()`` as its
    record call returned; the card records it some microseconds later,
    so a reading may run that much early) or, where none was, from one
    recorded after it."""
    after = None
    for _, frame, marks, anchor in pending:
        if anchor is not None:
            ev, ns = anchor
            ev.synchronize()        # done already, in the engine
            times = [ns + round(ev.elapsed_time(e) * 1e6)
                     for e in marks.times]
        else:
            if after is None:
                marks.times[-1].synchronize()
                after = (torch.cuda.Event(enable_timing=True), 0)
                after[0].record()
                after = (after[0], time.time_ns())
                after[0].synchronize()
            ev, ns = after
            times = [ns - round(e.elapsed_time(ev) * 1e6)
                     for e in marks.times]
        with _LOCK:
            _readings.append((frame, list(zip(marks.labels, times))))


def export() -> dict:
    """What the recorder holds, after reading the replays nobody waited
    for: ``spans``, a list of dicts (``id``, ``name``, ``t0``, ``t1``,
    ``frame``, ``parent``, ``stage``; ns on ``time.time_ns``'s clock), and
    ``stages``, one dict a program run (``frame``, ``marks``: [label, ns]
    pairs, in order, the last labelled ``END``)."""
    pending = _take(lambda p: True)
    for p in pending:
        p[2].times[-1].synchronize()
    _read(pending)
    with _LOCK:
        spans = [{k: getattr(s, k) for k in Span.__slots__}
                 for s in _spans]
        readings = [{"frame": f, "marks": [list(m) for m in marks]}
                    for f, marks in _readings]
    return {"spans": spans, "stages": readings}


# -- the reduction -----------------------------------------------------------

def _segments(marks) -> dict:
    """{stage: ns} of one reading (a stage that recurs sums its
    segments)."""
    out = {}
    for (label, t0), (_, t1) in zip(marks, marks[1:]):
        out[label] = out.get(label, 0) + (t1 - t0)
    return out


def _innermost(gap0: int, gap1: int, spans: list, depth: dict) -> dict:
    """{span name: ns} of [gap0, gap1], each instant put down to the
    deepest span covering it ("(none)" where none does)."""
    inside = [s for s in spans if s["t0"] < gap1 and s["t1"] > gap0]
    cuts = sorted({gap0, gap1} | {t for s in inside for t in (s["t0"],
                                                             s["t1"])
                                  if gap0 < t < gap1})
    out = {}
    for a, b in zip(cuts, cuts[1:]):
        cover = [s for s in inside if s["t0"] <= a and s["t1"] >= b]
        name = (max(cover, key=lambda s: (depth[s["id"]], s["t0"]))["name"]
                if cover else "(none)")
        out[name] = out.get(name, 0) + (b - a)
    return out


def reduce(export: dict, t0: int, t1: int) -> dict:
    """Per-frame means over the frames whose ``process_frame`` span lies
    in [t0, t1] (ns).

    Host, over the tracked frames (those with a ``track.replay``):
    ``host_frame_ms``, a frame's own time (its ``process_frame`` less the
    ``WAITS`` inside it), ``host_wait_ms`` (``engine.read_info``),
    ``mapping_ms`` (``mapmaker.step``), ``recorder_ms`` (``spans.read``)
    and ``period_ms``, from one frame's start to the next's.

    Device, over the stage readings in the interval: ``graph_ms`` (first
    marker to last), ``stage_ms`` {stage: ms}, ``gap_ms`` (one replay's
    last marker to the next frame's first) and ``gap_by_span_ms``, the gap
    put down to the innermost host span open at each instant.

    ``capture_s``: seconds of ``CAPTURES`` spans in the interval;
    ``frames``: tracked frames; ``readings``; ``frames_per_s``: every frame
    that ended in the interval, over it. A quantity with nothing to
    average is None."""
    spans = [s for s in export["spans"] if s["t0"] >= t0 and s["t1"] <= t1]
    by_id = {s["id"]: s for s in export["spans"]}
    depth = {}

    def depth_of(s):
        d, p = 0, s["parent"]
        while p is not None and p in by_id:
            d, p = d + 1, by_id[p]["parent"]
        return d

    for s in export["spans"]:
        depth[s["id"]] = depth_of(s)
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)

    def inside(s, names):
        """ns of ``names`` spans under ``s``, not counting one under
        another."""
        total = 0
        for k in kids.get(s["id"], ()):
            total += (k["t1"] - k["t0"] if k["name"] in names
                      else inside(k, names))
        return total

    def has(s, name):
        return any(k["name"] == name or has(k, name)
                   for k in kids.get(s["id"], ()))

    roots = sorted((s for s in spans if s["name"] == "process_frame"),
                   key=lambda s: s["t0"])
    tracked = [s for s in roots if has(s, "track.replay")]
    n = len(tracked)

    def mean(values, count):
        return sum(values) / count / 1e6 if count else None

    waits = [inside(s, ("engine.read_info",)) for s in tracked]
    maps = [inside(s, ("mapmaker.step",)) for s in tracked]
    reads = [inside(s, ("spans.read",)) for s in tracked]
    own = [s["t1"] - s["t0"] - inside(s, WAITS) for s in tracked]
    periods = [b["t0"] - a["t0"] for a, b in zip(tracked, tracked[1:])
               if b["frame"] == a["frame"] + 1]

    readings = sorted((r for r in export["stages"]
                       if t0 <= r["marks"][0][1]
                       and r["marks"][-1][1] <= t1),
                      key=lambda r: r["marks"][0][1])
    stage_ns = {}
    for r in readings:
        for label, ns in _segments(r["marks"]).items():
            stage_ns[label] = stage_ns.get(label, 0) + ns
    gaps, by_span = [], {}
    frame_spans = sorted((s for s in spans if s["frame"] is not None),
                         key=lambda s: s["t0"])
    starts = [s["t0"] for s in frame_spans]
    longest = max((s["t1"] - s["t0"] for s in frame_spans), default=0)
    for a, b in zip(readings, readings[1:]):
        if a["frame"] is None or b["frame"] != a["frame"] + 1:
            continue
        g0, g1 = a["marks"][-1][1], b["marks"][0][1]
        gaps.append(g1 - g0)
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        for name, ns in _innermost(g0, g1, frame_spans[lo:hi],
                                   depth).items():
            by_span[name] = by_span.get(name, 0) + ns
    k = len(readings)
    ended = sum(1 for s in export["spans"] if s["name"] == "process_frame"
                and t0 <= s["t1"] <= t1)
    return {
        "frames": n,
        "readings": k,
        "frames_per_s": ended / ((t1 - t0) / 1e9) if t1 > t0 else None,
        "host_frame_ms": mean(own, n),
        "host_wait_ms": mean(waits, n),
        "mapping_ms": mean(maps, n),
        "recorder_ms": mean(reads, n),
        "period_ms": mean(periods, len(periods)),
        "graph_ms": mean([r["marks"][-1][1] - r["marks"][0][1]
                          for r in readings], k),
        "stage_ms": {label: ns / k / 1e6 for label, ns in stage_ns.items()}
        if k else None,
        "gap_ms": mean(gaps, len(gaps)),
        "gap_by_span_ms": {name: ns / len(gaps) / 1e6
                           for name, ns in by_span.items()}
        if gaps else None,
        "capture_s": sum(s["t1"] - s["t0"] for s in spans
                         if s["name"] in CAPTURES) / 1e9,
    }


#: Name prefixes of the profiler's device activities that are no kernel.
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def profiled_replays(export: dict, prof) -> list:
    """Each stage reading beside its replay's device activity in a stopped
    ``torch.profiler.profile`` that recorded CUDA activity: [(reading,
    [(start ns, end ns, name), ...] sorted)], the replay being the CUDA
    graph launch whose call lies inside the reading's ``track.replay``
    span. Readings with no such launch are left out."""
    from torch.autograd import DeviceType
    calls, acts = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acts.setdefault(e.correlation_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.name().startswith("cudaGraphLaunch"):
            calls.append((e.start_ns(), e.correlation_id()))
    calls.sort()
    starts = [t for t, _ in calls]
    replays = {s["frame"]: s for s in export["spans"]
               if s["name"] == "track.replay"}
    out = []
    for r in export["stages"]:
        span = replays.get(r["frame"])
        if span is None:
            continue
        i = bisect.bisect_left(starts, span["t0"])
        if i < len(calls) and starts[i] <= span["t1"] and \
                calls[i][1] in acts:
            out.append((r, sorted(acts[calls[i][1]])))
    return out


def aligned(pairs) -> list:
    """``profiled_replays``' pairs with each replay's kernels moved so that
    its last activity ends at its end marker, which follows it at once:
    the profiler's device clock drifts off the host's by up to about
    1e-3 (PERF.md), the markers' does not."""
    out = []
    for r, acts in pairs:
        shift = r["marks"][-1][1] - max(e for _, e, _ in acts)
        out.append((r, [(a + shift, b + shift, n) for a, b, n in acts
                        if not n.startswith(NOT_KERNELS)]))
    return out


def stage_at(marks, t: int) -> str:
    """The stage of a reading's ``marks`` that holds ``t`` ("(outside)"
    before the first marker or after the last)."""
    i = bisect.bisect_right([ns for _, ns in marks], t) - 1
    return marks[i][0] if 0 <= i < len(marks) - 1 else "(outside)"


def placed(pairs) -> list:
    """For each of ``profiled_replays``' pairs, ``aligned``: whether each
    of its ``KERNEL_STAGES`` kernels lies (by its midpoint) in its
    stage."""
    return [all(stage_at(r["marks"], (a + b) // 2) == want
                for a, b, name in kernels
                for key, want in KERNEL_STAGES.items() if key in name)
            for r, kernels in aligned(pairs)]


def by_stage(pairs) -> dict:
    """{stage: [kernels, device ns]} of ``profiled_replays``' pairs,
    ``aligned``: each kernel by the stage of its own replay's reading
    that holds its midpoint."""
    out = {}
    for r, kernels in aligned(pairs):
        for a, b, _ in kernels:
            label = stage_at(r["marks"], (a + b) // 2)
            n, ns = out.get(label, (0, 0))
            out[label] = (n + 1, ns + b - a)
    return {k: list(v) for k, v in out.items()}
