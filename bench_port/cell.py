"""One run of a cell: set-up, the measured window, then the check.

Set-up (timed as ``setup_s``, from the process's start): the scene is made
and rendered on the device from the seed, the engine is built, and the
camera sweeps the configuration's arc from rest, forth and back: stereo
init, keyframes, BA, and every CUDA graph the run needs captured. It goes
on sweeping, a whole forth-and-back at a time, until a whole sweep added no
keyframe, captured no graph and left the MapMaker idle and converged: the
settled map of a user who works over a mapped workspace. Where the mix
covers the lens, set-up then covers it once, for the shortest cover, and
goes on until the engine has recovered (the relocalizer's graph is
captured there); the run fails if it does not. Where the mix explores
(``explore``, on a route), set-up instead flies the route's opening from
its first frame: init and the first keyframes, and the graphs a map of
that size needs; the run fails if the engine is not tracking at the
opening's end. Graphs that the map first needs later are captured in the
window, as a user's flight captures them.

The window: the sweep goes on over the mapped region, frames handed over
as the traffic mix says (``traffic.py``), each through
``SLAMEngine.process_frame``; a covered frame is handed over black. An
exploring window is instead the rest of the route, from the opening's end
to the route's, timed whole: new ground, which the map grows to take in.
With ``trace``, spans around ``process_frame``, ``MapMaker.step`` and
``RelocProgram``'s call are recorded for the whole window, and
``torch.profiler`` traces the device's activity over its last
``TRACE_SECONDS`` (the window is lengthened so that the traced stretch
lasts that long). Where the mix covers the lens, the traced stretch starts
at a cover's first frame instead, the first at or after that point
(lengthening the window to reach one), and lasts until that event has
recovered or been given up, if that is later. Exploring, it starts when
the frames left would take ``TRACE_SECONDS`` at the window's rate so far,
and lasts to the route's end: mapping over a map near its full size.

An event is one cover and what follows it. The engine reports a frame's
quality with the next frame (``good``): the event has recovered at the
first frame after the cover that is ``TRACKING`` with quality GOOD, which
the frame after it reports; it is unrecovered if the next cover starts
first, and cut if the window ends first. Covered frames, and every frame
of a cut event, are neither attempted nor judged; the frames from the
first uncovered one up to the recovered one are attempted and fail, and
are not judged; every frame from the recovered one on is judged, as every
frame of a window without covers is, whatever quality the engine gives
it.

After the window has closed and the peak memory is read, the engine's
poses and map go to the host, the engine is closed, and
``reference.judge`` computes the numbers that decide ``correct``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench_port import reference, roofline, scene
from bench_port import trace as tracelib
from bench_port import traffic as trafficlib

TRACE_SECONDS = 2.0
#: Set-up sweeps forth and back: at least MIN_SWEEPS (the same work on every
#: seed), then more until one adds no keyframe and captures nothing.
MIN_SWEEPS = 4
MAX_SWEEPS = 8


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with the nested dict ``over`` written over it."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def make_engine(cfg: dict, seed: int, device):
    """``run_tum``'s synchronous engine: mapping passes on the tracking
    thread."""
    from ptam_cg_tpu_torch import config as C
    from ptam_cg_tpu_torch.models import engine as englib
    e = cfg["engine"]
    cam = cfg["camera"]
    size = tuple(cam["image_size"])
    ecfg = C.EngineConfig(
        camera=C.CameraConfig(params=tuple(cam["params"]), image_size=size),
        tracker=C.TrackerConfig(**e.get("tracker", {})),
        mapmaker=C.MapMakerConfig(**e.get("mapmaker", {})),
        frontend=C.FrontendConfig(**e.get("frontend", {})))
    return englib.SLAMEngine(
        ecfg, image_size=size, max_points=e["max_points"],
        max_kfs=e["max_kfs"], seed=seed,
        auto_init_frames=e["auto_init_frames"], device=device)


class Patches:
    """Attributes this run replaced (a wrapper around an entry point), put
    back by ``undo`` when the run ends."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, attr: str, make) -> None:
        """Replace ``owner.attr`` by ``make(original)``."""
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def undo(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)


class Captures:
    """Counts CUDA graph captures in the process (every program's)."""

    def __init__(self, patches: Patches):
        self.n = 0

        def make(begin):
            def counted(graph, *a, **kw):
                self.n += 1
                return begin(graph, *a, **kw)
            return counted
        patches.wrap(torch.cuda.CUDAGraph, "capture_begin", make)


#: The tracker's quality GOOD (``tracker.QUALITY_GOOD``).
GOOD = 2


def good(info) -> bool:
    """A frame the engine reports tracking with quality GOOD. The engine
    defers a frame's decisions by one frame: a ``FrameInfo``'s quality is
    that of the frame before it."""
    return info.stage == "TRACKING" and info.quality == GOOD


def keyframe_lags(infos, landed, pending: int) -> list:
    """For each keyframe that the frames ``infos`` add (``added_kf``), in
    order: (the index of the frame that added it, that of the frame whose
    mapping pass landed its integration, or None where none did).
    ``landed``: the indices of the frames whose ``MapMaker.step`` returned
    a keyframe's slot, in order; the MapMaker integrates queued keyframes
    in turn, and ``pending`` were queued, and not landed, before the first
    frame."""
    added = [i for i, info in enumerate(infos) if info.added_kf]
    return [(a, landed[pending + j] if pending + j < len(landed) else None)
            for j, a in enumerate(added)]


def _landings(landed: list, all_infos: list):
    """A wrapper of ``MapMaker.step`` (for ``Patches.wrap``) that notes in
    ``landed`` the index of each frame whose pass landed an integration."""
    def make(step):
        def counted(*a, **kw):
            slot = step(*a, **kw)
            if slot is not None:
                landed.append(len(all_infos))
            return slot
        return counted
    return make


@dataclasses.dataclass
class Outcome:
    window_s: float
    infos: list            # the window's FrameInfos
    frame_idx: list        # their frames' indices in the sequence
    counted: np.ndarray    # (window frames,) bool: attempted
    lost: np.ndarray       # (window frames,) bool: after a cover, before
    #                        its recovery (attempted, and failed)
    memory_peak: int
    checks: dict           # reference.judge's numbers
    ctx: dict              # what the metrics' readers read
    notes: list            # lines for standard error


def _sync(device):
    if torch.device(device).type == "cuda":
        from ptam_cg_tpu_torch.models import graphs
        graphs.synchronize()


def settled(eng) -> bool:
    mm = eng.mapmaker
    return (eng.stage.name == "TRACKING" and not mm.integrating()
            and mm.converged_recent and mm.converged_full)


def run(spec, name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides: dict | None = None, tamper=None):
    """Run cell ``name``. ``overrides``: written over the configuration
    (the lower-precision control). ``tamper(eng)``: called on the engine
    before the first frame (the tests' broken timed paths)."""
    # The configurations state float32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(name)
    cfg = merge(spec.config(cell["config"]), overrides)
    mix = trafficlib.read(spec.traffic(cell["traffic"]), cfg["path"])
    covers = trafficlib.Covers(mix.get("cover"), seed)
    notes = []
    patches = Patches()
    try:
        return _run(cfg, covers, mix.get("explore"), seed, seconds, trace,
                    device, t_start, tamper, notes, patches)
    finally:
        patches.undo()


def _run(cfg, covers, explore, seed, seconds, trace, device, t_start,
         tamper, notes, patches):
    from ptam_cg_tpu_torch.models import mapmaker as mmlib
    from ptam_cg_tpu_torch.models import programs
    caps = Captures(patches)
    spans = tracelib.Spans()
    all_infos = []
    rec = roofline.Recorder()
    if trace:
        rec.install(patches)
        spans.wrap(patches, mmlib.MapMaker, "step", tracelib.STEP)
        spans.wrap(patches, programs.RelocProgram, "__call__",
                   tracelib.RELOC)
    landed = []
    if explore is not None:
        patches.wrap(mmlib.MapMaker, "step", _landings(landed, all_infos))
    seq = scene.Sequence(cfg, seed, device, None if explore is None
                         else explore["opening"] + explore["frames"])
    eng = make_engine(cfg, seed, device)
    if tamper is not None:
        tamper(eng)
    path = seq.path
    black = np.zeros_like(seq.frame(0))
    all_k = []
    left_out = range(0)     # set-up's frames covered, or lost after it

    def feed(k, covered=False):
        t0 = time.time_ns()
        info = eng.process_frame(black if covered else seq.frame(k))
        if trace:
            spans.add(tracelib.FRAME, t0, time.time_ns())
        all_k.append(k)
        all_infos.append(info)
        return info

    try:
        if explore is None:
            k = _sweep_setup(eng, path, feed, caps, all_infos, notes)
        else:
            k = _explore_setup(explore, eng, path, feed, caps, all_infos,
                               notes)
        if covers.cover is not None:
            n0 = len(all_infos)
            k, n_left = _setup_cover(covers.cover, feed, k, caps, notes)
            left_out = range(n0, n0 + n_left)
        n_setup = len(all_infos)
        caps_setup = caps.n
        kfs0, points0 = eng.mapmaker.n_kfs(), all_infos[-1].n_points
        if trace:
            # The profiler's first start sets up its device tracing, which
            # takes seconds: done here, so the window's start is quick.
            _stop_profile(*_start_profile(device), device)

        # ---- the window ----
        t_w0, tw0_ns = time.perf_counter(), time.time_ns()
        setup_s = t_w0 - t_start
        returned, handed, events = [], [], []
        prof = w0 = w1 = traced = None
        end_s = seconds
        if explore is not None:
            k, prof, w0 = _explore_window(explore, feed, k, t_w0, trace,
                                          device, returned)
        elif covers.cover is None:
            while (now := time.perf_counter() - t_w0) < end_s:
                if trace and prof is None and now >= seconds - TRACE_SECONDS:
                    prof, w0 = _start_profile(device)
                    # The traced stretch lasts TRACE_SECONDS from its start.
                    end_s = max(seconds, time.perf_counter() - t_w0
                                + TRACE_SECONDS)
                feed(k)
                returned.append(time.perf_counter())
                k += 1
        else:
            k, prof, w0, traced = _covered_window(
                covers, feed, k, t_w0, seconds, trace, device, handed,
                returned, events)
        _sync(device)
        t_w1, tw1_ns = time.perf_counter(), time.time_ns()
        if prof is not None:
            w1 = _stop_profile(prof, w0, device)
        for e in events:
            if e["status"] is None:
                e["status"] = "cut"
        window_s = t_w1 - t_w0
        memory_peak = (torch.cuda.max_memory_allocated()
                       if torch.device(device).type == "cuda" else 0)
        infos = all_infos[n_setup:]

        # ---- the outputs, to the host ----
        R = torch.stack([x.pose.R for x in all_infos]).double().cpu().numpy()
        t = torch.stack([x.pose.t for x in all_infos]).double().cpu().numpy()
        m = eng.snapshot()
        kv = m.kf_valid.cpu()
        kf_R = m.kf_R[kv.to(m.kf_R.device)].double().cpu().numpy()
        kf_t = m.kf_t[kv.to(m.kf_t.device)].double().cpu().numpy()
        kf_atlas = m.kf_atlas[kv.to(m.kf_atlas.device)].float().cpu().numpy()
        pv = m.point_valid
        points = m.point_pos[pv].double().cpu().numpy()
        del m
    finally:
        eng.close()
    captures_in_window = caps.n - caps_setup
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    covered, lost_w, cut = _roles(events, len(infos))
    judged = ~(covered | lost_w | cut)
    excluded = np.zeros(len(all_infos), dtype=bool)
    excluded[left_out] = True
    excluded[n_setup:] = ~judged
    # The map's frame and scale are those of the last init: the alignment
    # uses the frames tracked since then (a reset in the window leaves the
    # window's earlier frames to fail), less those a cover left out.
    tracked = np.array([x.stage == "TRACKING" for x in all_infos])
    lost = np.flatnonzero(~tracked)
    if len(lost):
        tracked[: lost[-1] + 1] = False
    tracked &= ~excluded
    window = np.zeros(len(all_infos), dtype=bool)
    window[n_setup:] = True
    reloc = None
    if covers.cover is not None:
        reloc = dict(pairs=[], unrecovered=sum(
            e["status"] == "unrecovered" for e in events))
        for e in events:
            if e["status"] != "recovered":
                continue
            u = e["start"] + e["frames"]
            e.update(first=u, recovery_s=returned[e["reported"]] - handed[u])
            # The last frame judged before the cover.
            a = next((j for j in range(e["start"] - 1, -1, -1)
                      if judged[j]), None)
            if a is not None:
                reloc["pairs"].append((n_setup + a, n_setup + e["recovered"]))
    checks = reference.judge(seq, np.array(all_k), R, t, tracked,
                             window & ~excluded, kf_R, kf_t, kf_atlas, points,
                             reloc=reloc)
    gaps = np.diff(np.array([t_w0] + returned)) * 1e3
    quarters = np.histogram(np.array(returned) - t_w0, bins=4,
                            range=(0.0, window_s))[0]
    notes.append(f"window: {len(infos)} frames in {window_s:.3f} s "
                 f"(by quarter {quarters.tolist()}; ms between returns p50 "
                 f"{np.median(gaps):.3f}, p99 {np.percentile(gaps, 99):.3f}, "
                 f"max {gaps.max():.3f}, {int((gaps > 20).sum())} over 20), "
                 f"{captures_in_window} graph captures, "
                 f"{len(kf_R)} keyframes, {len(points)} points at the end")
    keyframes = None
    if explore is not None:
        # Keyframes queued in the opening, less those landed before the
        # window: the window's first landings are theirs.
        opening = range(n_setup - explore["opening"], n_setup)
        pending = (sum(all_infos[i].added_kf for i in opening)
                   - sum(i in opening for i in landed))
        keyframes = keyframe_lags(
            infos, [i - n_setup for i in landed if i >= n_setup], pending)
        waits = [(len(infos) - 1 if c is None else c) - a
                 for a, c in keyframes]
        checks.update(kfs_added=float(len(keyframes)),
                      kf_lag_frames_max=float(max(waits, default=0)))
        notes.append(
            f"explore: {kfs0} keyframes and {points0} points at the "
            f"window's start; {len(keyframes)} keyframes added in it, "
            f"{sum(c is None for _, c in keyframes)} not landed by its end, "
            f"each waiting up to {max(waits, default=0)} frames for its "
            f"integration to land")
    if events:
        done = [e for e in events if e["status"] == "recovered"]
        notes.append(
            f"events: {len(events)} covers of {[e['frames'] for e in events]}"
            f" frames; {len(done)} recovered, reported after "
            f"{[e['reported'] - e['first'] + 1 for e in done]} frames, in "
            f"{[round(e['recovery_s'] * 1e3, 3) for e in done]} ms; "
            f"{reloc['unrecovered']} unrecovered; "
            f"{sum(e['status'] == 'cut' for e in events)} cut by the end")
    ctx = dict(setup_s=setup_s, window_s=window_s, frames=len(infos),
               spans=spans, recorder=rec, window_ns=(tw0_ns, tw1_ns),
               trace=None, events=events, n_setup=n_setup, trace_ns=None,
               infos=infos, returned=returned, keyframes=keyframes)
    if prof is not None:
        ctx["trace_ns"] = (w0, w1)
        ctx["trace"] = _reduce(prof, w0, w1, spans, all_infos, notes)
        if traced is not None:
            e = events[traced]
            notes.append(f"trace: holds the event at window frame "
                         f"{e['start']} whole: {e['status']}")
    return Outcome(window_s, infos, all_k[n_setup:], ~(covered | cut), lost_w,
                   memory_peak, checks, ctx, notes)


def _sweep_setup(eng, path, feed, caps, all_infos, notes) -> int:
    """Set-up on an arc: the first forth-and-back, then until settled.
    Returns the next frame's index."""
    sweep = 2 * path.n_sweep
    end, k = path.ramp + sweep, 0
    quiet = False
    for n_sweeps in range(1, MAX_SWEEPS + 1):
        caps0, kf0 = caps.n, sum(i.added_kf for i in all_infos)
        while k < end:
            feed(k)
            k += 1
        quiet = (n_sweeps >= MIN_SWEEPS and caps.n == caps0
                 and settled(eng)
                 and sum(i.added_kf for i in all_infos) == kf0)
        if quiet:
            break
        end += sweep
    stages = [i.stage for i in all_infos]
    first = stages.index("TRACKING") if "TRACKING" in stages else None
    notes.append(
        f"set-up: {k} frames ({n_sweeps} sweeps forth and back of "
        f"{path.n_sweep} frames after a {path.ramp}-frame ramp; "
        f"{path.speed_deg_s:.2f} deg/s, {path.speed_m_s:.3f} m/s), "
        f"first tracked frame {first}, {eng.mapmaker.n_kfs()} keyframes, "
        f"{all_infos[-1].n_points} points, {caps.n} graph captures; "
        f"settled: {quiet}")
    if first is None:
        raise RuntimeError("set-up: the engine never initialized")
    return k


def _explore_setup(explore, eng, path, feed, caps, all_infos,
                   notes) -> int:
    """Set-up on a route: its opening from the first frame (init and the
    first keyframes). Returns the next frame's index, the opening's end;
    raises unless the engine is tracking there."""
    for k in range(explore["opening"]):
        feed(k)
    stages = [i.stage for i in all_infos]
    first = stages.index("TRACKING") if "TRACKING" in stages else None
    notes.append(
        f"set-up: the route's opening, {explore['opening']} of its "
        f"{path.n_unique} frames (after a {path.ramp}-frame ramp; "
        f"{path.speed_deg_s:.2f} deg/s, {path.speed_m_s:.3f} m/s, swaying "
        f"{path.sway_deg:.2f} deg): first tracked frame {first}, "
        f"{eng.mapmaker.n_kfs()} keyframes, {all_infos[-1].n_points} "
        f"points, {caps.n} graph captures")
    if stages[-1] != "TRACKING":
        raise RuntimeError("set-up: the engine is not tracking at the "
                           "opening's end")
    return explore["opening"]


def _explore_window(explore, feed, k, t_w0, trace, device, returned):
    """The window on a route: its frames from ``k``, the opening's end, to
    its end. Traced, the stretch starts when the frames left would take
    ``TRACE_SECONDS`` at the window's rate so far. Returns the next frame's
    index, the profiler and its start."""
    prof = w0 = None
    end = explore["opening"] + explore["frames"]
    while k < end:
        done = k - explore["opening"]
        if (trace and prof is None and done and (end - k) * (
                time.perf_counter() - t_w0) / done <= TRACE_SECONDS):
            prof, w0 = _start_profile(device)
        feed(k)
        returned.append(time.perf_counter())
        k += 1
    return k, prof, w0


def _covered_window(covers, feed, k, t_w0, seconds, trace, device, handed,
                    returned, events):
    """The window under a cover schedule: frame ``n`` of the window is
    handed over black while covered; each cover opens an event in
    ``events``. Traced, the stretch starts at a cover's first frame and
    lasts until that event has recovered or been given up. Returns the
    next frame's index, the profiler, its start and the traced event."""
    prof = w0 = traced = pending = None
    end_s, n = seconds, 0
    while ((now := time.perf_counter() - t_w0) < end_s
           or (trace and (traced is None
                          or events[traced]["status"] is None))):
        i, covered = covers.at(n)
        starts = covered and n == covers.start(i)
        if starts:
            events.append(dict(start=n, frames=covers.length(i),
                               recovered=None, status=None))
        if (trace and prof is None and now >= seconds - TRACE_SECONDS
                and starts):
            prof, w0 = _start_profile(device)
            traced = len(events) - 1
            end_s = max(seconds, time.perf_counter() - t_w0
                        + TRACE_SECONDS)
        handed.append(time.perf_counter())
        info = feed(k, covered)
        returned.append(time.perf_counter())
        # This frame reports the quality of the one before it.
        if (pending is not None and good(info)
                and n > pending["start"] + pending["frames"]):
            pending.update(status="recovered", recovered=n - 1, reported=n)
            pending = None
        if starts:
            if pending is not None:
                pending["status"] = "unrecovered"
            pending = events[-1]
        k += 1
        n += 1
    return k, prof, w0, traced


def _setup_cover(cover, feed, k: int, caps, notes):
    """Set-up's one cover, the shortest the mix draws, and the frames up to
    the report of its recovery (the relocalizer's graph is captured on
    them). Returns the next frame's index and the frames handed over
    before the recovered one; raises if the engine does not recover before
    the next cover would start."""
    caps0 = caps.n
    lo = cover["frames"][0]
    for j in range(cover["every_frames"]):
        info = feed(k, j < lo)
        k += 1
        if j > lo and good(info):
            notes.append(f"set-up cover: {lo} frames covered, recovery "
                         f"reported after {j - lo + 1} frames; "
                         f"{caps.n - caps0} graph captures")
            return k, j - 1
    raise RuntimeError(f"set-up: the engine did not recover from a cover "
                       f"of {lo} frames within {cover['every_frames'] - lo} "
                       f"frames")


def _roles(events, n: int):
    """(covered, lost, cut) masks over the window's ``n`` frames: covered
    by an event's cover; after it and before its recovered frame (or,
    unrecovered, the next cover); any frame of an event the window's end
    cut."""
    covered, lost, cut = (np.zeros(n, dtype=bool) for _ in range(3))
    for j, e in enumerate(events):
        s, u = e["start"], e["start"] + e["frames"]
        if e["status"] == "cut":
            cut[s:] = True
        else:
            covered[s:u] = True
            lost[u:e["recovered"] if e["status"] == "recovered"
                 else events[j + 1]["start"]] = True
    return covered, lost, cut


def _start_profile(device):
    """Start tracing the device's activity. On the card only CUDA activity
    is recorded: the kernels, copies and fills, and the runtime calls that
    launched them (their correlation places a kernel in a span); the host's
    operators, which no metric reads, are not."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    _sync(device)
    prof.start()
    return prof, time.time_ns()


def _stop_profile(prof, w0, device) -> int:
    _sync(device)
    w1 = time.time_ns()
    prof.stop()
    return w1


def _reduce(prof, w0, w1, spans, infos, notes) -> dict:
    """The traced window's numbers the per-layer readers read."""
    tr = tracelib.read_profile(prof, w0, w1)
    if not tr.acts:
        notes.append("trace: the profiler recorded no device activity")
        return None
    track, mapping, unplaced = tracelib.attribute(tr, spans)
    reloc, _, _ = tracelib.launched_in(tr, spans, tracelib.RELOC)
    busy_s, _ = tracelib.union_seconds(tr.acts, w0, w1)
    # FRAME spans are recorded in the order of ``infos``.
    in_window = [info for s, info in zip(spans.of(tracelib.FRAME), infos)
                 if w0 <= s[2] <= w1]
    n_tracked = sum(1 for info in in_window if info.stage == "TRACKING")
    notes.append(
        f"trace: {tr.window_s:.3f} s, {len(tr.acts)} device activities "
        f"({sum(a.kernel for a in tr.acts)} kernels), {len(track)} tracking, "
        f"{len(mapping)} mapping, {unplaced} with no launching call found; "
        f"{len(in_window)} frames returned, {n_tracked} tracked")
    return dict(trace=tr, window_s=tr.window_s, busy_s=busy_s,
                track_s=sum(a.end - a.start for a in track) / 1e9,
                track_kernels=sum(a.kernel for a in track),
                map_s=sum(a.end - a.start for a in mapping) / 1e9,
                frames=n_tracked, frames_returned=len(in_window),
                reloc_s=sum(a.end - a.start for a in reloc) / 1e9,
                reloc_calls=sum(1 for _, t0, t1 in spans.of(tracelib.RELOC)
                                if w0 <= t0 and t1 <= w1),
                breakdown=tracelib.breakdown(tr, spans))
