"""One run of a cell: set-up, the measured window, then the check.

Set-up (timed as ``setup_s``, from the process's start): the scene is made
and rendered on the device from the seed, the engine is built, and the
camera sweeps the configuration's arc from rest, forth and back: stereo
init, keyframes, BA, and every CUDA graph the run needs captured. It goes
on sweeping, a whole forth-and-back at a time, until a whole sweep added no
keyframe, captured no graph and left the MapMaker idle and converged: the
settled map of a user who works over a mapped workspace.

The window: the sweep goes on over the mapped region, frames handed over
as the traffic mix says (``traffic.py``), each through
``SLAMEngine.process_frame``. With ``trace``, spans around
``process_frame`` and ``MapMaker.step`` are recorded for the whole window,
and ``torch.profiler`` traces the device's activity over its last
``TRACE_SECONDS`` (the window is lengthened so that the traced stretch
lasts that long).

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


@dataclasses.dataclass
class Outcome:
    window_s: float
    infos: list            # the window's FrameInfos
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
    trafficlib.read(spec.traffic(cell["traffic"]))
    notes = []
    patches = Patches()
    try:
        return _run(cfg, seed, seconds, trace, device, t_start, tamper, notes,
                    patches)
    finally:
        patches.undo()


def _run(cfg, seed, seconds, trace, device, t_start, tamper, notes, patches):
    from ptam_cg_tpu_torch.models import mapmaker as mmlib
    caps = Captures(patches)
    spans = tracelib.Spans()
    rec = roofline.Recorder()
    if trace:
        rec.install(patches)
        spans.wrap(patches, mmlib.MapMaker, "step", tracelib.STEP)
    seq = scene.Sequence(cfg, seed, device)
    eng = make_engine(cfg, seed, device)
    if tamper is not None:
        tamper(eng)
    path = seq.path
    all_k, all_infos = [], []

    def feed(k):
        t0 = time.time_ns()
        info = eng.process_frame(seq.frame(k))
        if trace:
            spans.add(tracelib.FRAME, t0, time.time_ns())
        all_k.append(k)
        all_infos.append(info)
        return info

    try:
        # ---- set-up: the first forth-and-back, then until settled ----
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
        n_setup = len(all_infos)
        caps_setup = caps.n
        if trace:
            # The profiler's first start sets up its device tracing, which
            # takes seconds: done here, so the window's start is quick.
            _stop_profile(*_start_profile(device), device)

        # ---- the window ----
        t_w0, tw0_ns = time.perf_counter(), time.time_ns()
        setup_s = t_w0 - t_start
        returned = []
        prof = w0 = w1 = None
        end_s = seconds
        while (now := time.perf_counter() - t_w0) < end_s:
            if trace and prof is None and now >= seconds - TRACE_SECONDS:
                prof, w0 = _start_profile(device)
                # The traced stretch lasts TRACE_SECONDS from its start.
                end_s = max(seconds, time.perf_counter() - t_w0
                            + TRACE_SECONDS)
            feed(k)
            returned.append(time.perf_counter())
            k += 1
        _sync(device)
        t_w1, tw1_ns = time.perf_counter(), time.time_ns()
        if prof is not None:
            w1 = _stop_profile(prof, w0, device)
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

    # The map's frame and scale are those of the last init: the alignment
    # uses the frames tracked since then (a reset in the window leaves the
    # window's earlier frames to fail).
    tracked = np.array([x.stage == "TRACKING" for x in all_infos])
    lost = np.flatnonzero(~tracked)
    if len(lost):
        tracked[: lost[-1] + 1] = False
    window = np.zeros(len(all_infos), dtype=bool)
    window[n_setup:] = True
    checks = reference.judge(seq, np.array(all_k), R, t, tracked, window,
                             kf_R, kf_t, kf_atlas, points)
    gaps = np.diff(np.array([t_w0] + returned)) * 1e3
    quarters = np.histogram(np.array(returned) - t_w0, bins=4,
                            range=(0.0, window_s))[0]
    notes.append(f"window: {len(infos)} frames in {window_s:.3f} s "
                 f"(by quarter {quarters.tolist()}; ms between returns p50 "
                 f"{np.median(gaps):.3f}, p99 {np.percentile(gaps, 99):.3f}, "
                 f"max {gaps.max():.3f}, {int((gaps > 20).sum())} over 20), "
                 f"{captures_in_window} graph captures, "
                 f"{len(kf_R)} keyframes, {len(points)} points at the end")
    ctx = dict(setup_s=setup_s, window_s=window_s, frames=len(infos), spans=spans, recorder=rec,
               window_ns=(tw0_ns, tw1_ns), trace=None)
    if prof is not None:
        ctx["trace"] = _reduce(prof, w0, w1, spans, all_infos, notes)
    return Outcome(window_s, infos, memory_peak, checks, ctx, notes)


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
                breakdown=tracelib.breakdown(tr, spans))
