"""What a CUDA-graph capture on the engine's mapping worker waits on
(the PyTorch port, ``ptam_cg_tpu_torch``), on one CUDA card.

    python3 profile_torch_captures.py [--frames N] [--out FILE]

1. The interpreter lock across a host wait. A thread counts Python loop
   iterations while the main thread waits ~40 ms for the card
   (``torch.cuda._sleep``) in each way a tracked frame can read a value
   back: ``tolist``, ``item``, ``cpu``, a copy into pinned memory read
   after ``Event.synchronize``, a stream sync; and ``time.sleep`` as the
   lock-free reference. A wait that keeps the lock stops the count. Then
   the time the main thread needs to get the lock back after a wait, while
   the counting thread wants it, at the interpreter's switch intervals.
2. The engine with its mapping worker (``SLAMEngine(async_mapping=True)``,
   latency mode) on bench_engine.py's scene at 640x480 (the frames of
   ``chip_smoke.py`` phase 11, 4,096 points, 16 keyframes), one fresh
   engine a variant: ``wait`` blocks each frame while a capture is under
   way (what the port did before), ``no wait`` does not, ``event read``
   reads the frame's info vector through pinned memory and an event,
   ``switch`` sets the interpreter's switch interval. For each: FPS,
   latency percentiles, every capture (program, thread, seconds of the
   whole call and of the capture proper) with the tracked frames it
   overlapped, and the tracking thread's seconds in its info read.
3. Each chunk graph of variant ``no wait`` captured again on a thread of
   its own while nothing else runs (the standalone time), and the worker's
   captures and the standalone ones under ``cProfile``: the functions
   that take the time (``cProfile`` in Python 3.12 sees every thread).
4. What holds a capture back, without the engine: a thread captures the
   same program of 2,000 small kernels (``graphs.Job``) again and again
   while the main thread, in a loop, keeps the card busy for ~10 ms and
   then waits for it in one of section 1's ways, or blocks on a lock
   (what the port's frames did while the worker captured), or also runs
   5 ms of Python after each wait (as a tracked frame's host work).
6. With ``--repeat N``: section 2's ``no wait, event read`` engine N
   times in one process, each capture with its seconds in
   ``CUDAGraph.capture_end`` (the instantiation) and the device
   allocations (``cudaMalloc`` calls) made meanwhile.
5. With ``--after-profiler``: section 4 (event read, with and without
   the Python) and section 2's ``no wait, event read`` engine, before and
   after one ``torch.profiler`` session of CUDA activity in the same
   process (as ``chip_smoke.py`` runs many before its phase 12), in
   place of sections 1-3.

Prints one line per measurement, the card's name and power limit beside
each number, and with ``--out FILE`` writes every number to it as JSON.
Needs a card; builds the kernels from the checkout
(``kernels/_build.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import threading
import time

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (640, 480)
SEQ = dict(n_frames=240, seed=7, height=1.5, radius=0.35, sweep=1.3)
CAND_MIN = 100.0
CAPACITY = dict(max_points=4096, max_kfs=16, auto_init_frames=6, seed=0)
WAIT_MS = 40.0


def gil_probe(torch, card, out):
    """Section 1: does each host wait keep the interpreter lock, and what
    does taking it back cost beside a thread that wants it."""
    dev = torch.device("cuda")
    x = torch.arange(5, dtype=torch.int64, device=dev)
    pinned = torch.empty(5, dtype=torch.int64, pin_memory=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * WAIT_MS / start.elapsed_time(end))

    def event_read():
        pinned.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return pinned.tolist()

    waits = {"tolist": lambda: x.tolist(), "item": lambda: x[0].item(),
             "cpu": lambda: x.cpu(), "event read": event_read,
             "stream sync": lambda: torch.cuda.current_stream().synchronize(),
             "time.sleep": lambda: time.sleep(WAIT_MS / 1e3)}
    count, stop = [0], threading.Event()

    def counter():
        while not stop.is_set():
            count[0] += 1
    res = {}
    for switch in (5e-3, 1e-3, 2e-4):
        sys.setswitchinterval(switch)
        stop.clear()
        th = threading.Thread(target=counter)
        th.start()
        try:
            for name, wait in waits.items():
                rates, overs = [], []
                for _ in range(5):
                    if name != "time.sleep":
                        torch.cuda._sleep(cycles)
                    n0, t0 = count[0], time.perf_counter()
                    wait()
                    dt = time.perf_counter() - t0
                    rates.append((count[0] - n0) / dt)
                    overs.append(dt * 1e3 - WAIT_MS)
                res[(switch, name)] = dict(
                    rate=sorted(rates)[2], over_ms=sorted(overs)[2])
        finally:
            stop.set()
            th.join(10.0)
    sys.setswitchinterval(5e-3)
    for (switch, name), r in res.items():
        ref = res[(switch, "time.sleep")]["rate"]
        print(f"[gil] switch {switch * 1e3:.1f} ms, {name}: another thread "
              f"ran {r['rate'] / ref * 100:.0f}% of its lock-free rate "
              f"during the wait; the wait took {r['over_ms']:+.2f} ms beyond "
              f"{WAIT_MS:.0f} ms (median of 5)  [{card}]")
    out["gil"] = [dict(switch_ms=s * 1e3, wait=n, share=r["rate"]
                       / res[(s, "time.sleep")]["rate"],
                       over_ms=r["over_ms"]) for (s, n), r in res.items()]


def capture_beside_waits(torch, graphs, card, out, n_kernels=2000, reps=3,
                         names=None, tag=""):
    """Section 4: one program's capture time on a thread of its own while
    the main thread waits for the card in each way, or on a lock
    (``names``: those waits only)."""
    dev = torch.device("cuda")
    x = torch.zeros(1024, device=dev)
    info = torch.arange(5, dtype=torch.int64, device=dev)
    pinned = torch.empty(5, dtype=torch.int64, pin_memory=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * 10.0 / start.elapsed_time(end))

    def body(t):
        for _ in range(n_kernels):
            t.add_(1.0)
        return t

    def event_read():
        pinned.copy_(info, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return pinned.tolist()

    def event_read_python():
        event_read()
        t_end = time.perf_counter() + 5e-3
        while time.perf_counter() < t_end:
            pass
    lock = threading.Lock()
    waits = {"idle": None,
             "lock": "lock",
             "tolist": lambda: info.tolist(),
             "item": lambda: info[0].item(),
             "event read": event_read,
             "event read + 5 ms Python": event_read_python,
             "stream sync": lambda: torch.cuda.current_stream().synchronize()}
    res = {}
    for name, wait in waits.items():
        if names is not None and name not in names:
            continue
        secs, done = [], threading.Event()

        def capturer():
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(reps):
                    job = graphs.Job("probe", body, (x,), dev, True,
                                     pool=torch.cuda.graph_pool_handle())
                    t0 = time.perf_counter()
                    job.capture()
                    secs.append((time.perf_counter() - t0,
                                 job.graph.capture_s))
            done.set()
        if wait == "lock":
            lock.acquire()
        th = threading.Thread(target=capturer, name="capturer")
        th.start()
        n_waits = 0
        if wait == "lock":
            done.wait(600.0)
            lock.release()
        else:
            while not done.is_set():
                if wait is None:
                    time.sleep(0.01)
                else:
                    torch.cuda._sleep(cycles)
                    wait()
                n_waits += 1
        th.join(600.0)
        torch.cuda.synchronize()
        res[name] = dict(call_s=sorted(a for a, _ in secs)[reps // 2],
                         capture_s=sorted(b for _, b in secs)[reps // 2],
                         main_waits=n_waits)
        print(f"[beside{tag}] main thread {name}: capture of {n_kernels} "
              f"kernels on another thread {res[name]['call_s']:.3f} s in "
              f"all, {res[name]['capture_s']:.3f} s capturing (median of "
              f"{reps}); the main thread's waits meanwhile {n_waits}  "
              f"[{card}]")
    out["beside" + tag] = res


class Watch:
    """Records every capture (``graphs.Program.capture``) with its thread,
    host-clock span, seconds in ``capture_end`` and device allocations;
    stashes each chunk program made; samples where the mapping thread is
    while it captures; ``wait_for_captures`` blocks while one is under
    way."""

    def __init__(self, graphs, bundle, profile_thread=None):
        self.graphs, self.bundle = graphs, bundle
        self.caps, self.states = [], []
        self.under_way = 0
        self.cond = threading.Condition()
        self.profile_thread = profile_thread
        self.profiles = []
        #: Where the mapping thread was, sampled every 2 ms while it
        #: captured: {capture label: {(file:line function, ...): count}}.
        self.samples = {}
        self._local = threading.local()
        self._capturing = None
        self._stop = threading.Event()

    def _sample(self):
        while not self._stop.wait(0.002):
            cur = self._capturing
            if cur is None:
                continue
            label, ident = cur
            frame = sys._current_frames().get(ident)
            where = []
            while frame is not None and len(where) < 3:
                where.append(f"{os.path.basename(frame.f_code.co_filename)}:"
                             f"{frame.f_lineno} {frame.f_code.co_name}")
                frame = frame.f_back
            by = self.samples.setdefault(label, {})
            by[tuple(where)] = by.get(tuple(where), 0) + 1

    @contextlib.contextmanager
    def installed(self):
        g, b = self.graphs, self.bundle
        capture, chunk_init = g.Program.capture, b.ChunkProgram.__init__
        watch = self

        def watched_capture(prog):
            if prog.graph is not None:
                return capture(prog)
            name = threading.current_thread().name
            label = getattr(prog, "label", None) or type(prog).__name__
            with watch.cond:
                watch.under_way += 1
            prof = (cProfile.Profile() if name == watch.profile_thread
                    else None)
            if name == "mapping":
                watch._capturing = (label, threading.get_ident())
            allocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            watch._local.end_s = 0.0
            t0 = time.perf_counter()
            try:
                if prof is not None:
                    prof.enable()
                capture(prog)
            finally:
                if prof is not None:
                    prof.disable()
                t1 = time.perf_counter()
                watch._capturing = None
                with watch.cond:
                    watch.under_way -= 1
                    watch.cond.notify_all()
            watch.caps.append(dict(
                label=label, thread=name, t0=t0, t1=t1,
                capture_s=prog.graph.capture_s, end_s=watch._local.end_s,
                device_allocs=torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - allocs0))
            if prof is not None:
                watch.profiles.append((label, t1 - t0, prof))

        def stashing_init(prog, state, cam, cfg, kind, *a, **kw):
            chunk_init(prog, state, cam, cfg, kind, *a, **kw)
            watch.states.append((prog, cam, cfg, kind))
        import torch
        graph_cls = torch.cuda.CUDAGraph
        capture_end = graph_cls.capture_end

        def timed_end(graph):
            t = time.perf_counter()
            try:
                return capture_end(graph)
            finally:
                watch._local.end_s = getattr(watch._local, "end_s", 0.0) + (
                    time.perf_counter() - t)
        graph_cls.capture_end = timed_end
        g.Program.capture = watched_capture
        b.ChunkProgram.__init__ = stashing_init
        sampler = threading.Thread(target=self._sample, name="sampler")
        sampler.start()
        try:
            yield self
        finally:
            self._stop.set()
            sampler.join(10.0)
            g.Program.capture = capture
            b.ChunkProgram.__init__ = chunk_init
            graph_cls.capture_end = capture_end

    def wait_for_captures(self):
        with self.cond:
            while self.under_way:
                self.cond.wait()


def tolist_read(eng, info):
    quality, lost, n_found, need_kf, n_points = info.tolist()
    return _store(eng, quality, lost, n_found, need_kf, n_points)


def event_read(eng, info):
    import torch
    host = getattr(eng, "_probe_info", None)
    if host is None:
        host = eng._probe_info = torch.empty(5, dtype=info.dtype,
                                             pin_memory=True)
    host.copy_(info, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    quality, lost, n_found, need_kf, n_points = host.tolist()
    return _store(eng, quality, lost, n_found, need_kf, n_points)


def _store(eng, quality, lost, n_found, need_kf, n_points):
    eng._last_quality, eng._last_n_found = quality, n_found
    eng._n_points_host = n_points
    eng.mapmaker._n_points_hint = n_points
    return quality, lost, n_found, need_kf


def run_variant(torch, mods, frames, card, tag, wait, read, switch,
                profile=False):
    """Section 2: one fresh engine with the worker over ``frames``."""
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    graphs, bundle, englib = mods
    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=CAND_MIN))
    watch = Watch(graphs, bundle, "mapping" if profile else None)
    old_read = englib.SLAMEngine._read_info
    reads = []

    def timed_read(eng, info):
        t0 = time.perf_counter()
        try:
            return read(eng, info)
        finally:
            reads.append((t0, time.perf_counter()))
    englib.SLAMEngine._read_info = timed_read
    # The port before this script's change waited in process_frame itself.
    old_wait = getattr(graphs, "wait_for_capture", None)
    if old_wait is not None and not wait:
        graphs.wait_for_capture = lambda: None
    sys.setswitchinterval(switch)
    try:
        with watch.installed():
            eng = englib.SLAMEngine(cfg, image_size=SIZE, device="cuda",
                                    async_mapping=True, **CAPACITY)
            times, infos = [], []
            graphs.synchronize()
            t_start = time.perf_counter()
            for im in frames:
                if wait:
                    watch.wait_for_captures()
                t0 = time.perf_counter()
                infos.append(eng.process_frame(im))
                times.append((t0, time.perf_counter()))
            graphs.synchronize()
            wall = time.perf_counter() - t_start
            eng.close()
    finally:
        englib.SLAMEngine._read_info = old_read
        if old_wait is not None:
            graphs.wait_for_capture = old_wait
        sys.setswitchinterval(5e-3)
    tracked = [(k, (t1 - t0) * 1e3) for k, (t0, t1) in enumerate(times)
               if infos[k].stage == "TRACKING" and not infos[k].added_kf]
    lat = sorted(ms for _, ms in tracked)
    pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
    good = sum(i.quality == 2 for i in infos if i.stage == "TRACKING")
    n_tracked = sum(i.stage == "TRACKING" for i in infos)
    res = dict(tag=tag, wait=wait, read=read.__name__, switch_ms=switch * 1e3,
               fps=len(frames) / wall, p50=pct(0.5), p95=pct(0.95),
               max=lat[-1], good=good, tracked=n_tracked, captures=[])
    print(f"[run] {tag}: {res['fps']:.2f} FPS over {len(frames)} frames; "
          f"tracked-frame latency p50 {res['p50']:.1f} ms, p95 "
          f"{res['p95']:.1f} ms, max {res['max']:.1f} ms; {good}/{n_tracked} "
          f"tracked frames GOOD  [{card}]")
    for c in watch.caps:
        over = [(k, round(ms, 1)) for k, ms in tracked
                if times[k][0] < c["t1"] and times[k][1] > c["t0"]]
        in_read = sum(max(0.0, min(t1, c["t1"]) - max(t0, c["t0"]))
                      for t0, t1 in reads)
        res["captures"].append(dict(
            label=c["label"], thread=c["thread"], call_s=c["t1"] - c["t0"],
            capture_s=c["capture_s"], frames=over, in_read_s=in_read))
        res["captures"][-1].update(end_s=c["end_s"],
                                   device_allocs=c["device_allocs"])
        if c["thread"] == "mapping":
            print(f"[run] {tag}: capture {c['label']} on {c['thread']}: "
                  f"{c['t1'] - c['t0']:.3f} s in all, {c['capture_s']:.3f} s "
                  f"capturing, {c['end_s']:.3f} s of it instantiating, "
                  f"{c['device_allocs']} device allocations; overlapped "
                  f"{len(over)} tracked frames, "
                  f"longest {max((ms for _, ms in over), default=0):.1f} ms; "
                  f"tracking thread in its info read {in_read:.3f} s of it")
    res["samples"] = {}
    for label, by in watch.samples.items():
        if "chunk" not in label and label != "insert":
            continue
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        n = sum(by.values())
        res["samples"][label] = [(list(k), v) for k, v in top]
        print(f"[where] {tag}: {label}, {n} samples of the mapping thread: "
              + "; ".join(f"{v / n * 100:.0f}% {' < '.join(k)}"
                          for k, v in top))
    return res, watch


def standalone(torch, mods, watch, card, profile):
    """Section 3: each chunk program of a run captured again on a thread
    of its own (a stream of its own) while nothing else runs."""
    graphs, bundle, _ = mods
    out, keep = [], []

    def capture_all():
        with torch.cuda.stream(torch.cuda.Stream()):
            for prog, cam, cfg, kind in watch.states:
                if prog.graph is None:
                    continue
                fresh = bundle.ChunkProgram(prog.state, cam, cfg, kind,
                                            graphs=True,
                                            pool=torch.cuda
                                            .graph_pool_handle())
                fresh.label = prog.label
                prof = cProfile.Profile() if profile else None
                t0 = time.perf_counter()
                if prof is not None:
                    prof.enable()
                fresh.capture()
                if prof is not None:
                    prof.disable()
                t1 = time.perf_counter()
                keep.append(fresh)
                out.append(dict(label=fresh.label, call_s=t1 - t0,
                                capture_s=fresh.graph.capture_s))
                if prof is not None:
                    watch.profiles.append(("standalone " + fresh.label,
                                           t1 - t0, prof))
    th = threading.Thread(target=capture_all, name="standalone")
    th.start()
    th.join(600.0)
    for s in out:
        print(f"[alone] {s['label']}: {s['call_s']:.3f} s in all, "
              f"{s['capture_s']:.3f} s capturing, nothing else running  "
              f"[{card}]")
    return out


def top_functions(prof, n=12):
    buf = io.StringIO()
    st = pstats.Stats(prof, stream=buf)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [dict(fn=f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", calls=v[1],
                 tottime=v[2], cumtime=v[3]) for k, v in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--out", help="a JSON file for every number")
    ap.add_argument("--skip-gil", action="store_true",
                    help="leave out section 1")
    ap.add_argument("--after-profiler", action="store_true",
                    help="section 5 in place of sections 1-3")
    ap.add_argument("--repeat", type=int, default=0,
                    help="section 6 with N runs in place of sections 1-3")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import _build
    from ptam_cg_tpu_torch.models import bundle, graphs
    from ptam_cg_tpu_torch.models import engine as englib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0]})"
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    _build.load_all([(k, ()) for k in ("fast10", "gather_windows",
                                       "shi_tomasi", "graph_cond")])
    out = dict(card=card)
    if not args.skip_gil:
        gil_probe(torch, card, out)
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device="cuda",
                                  **SEQ)
    frames = [seq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
              for i in range(args.frames)]
    mods = (graphs, bundle, englib)
    if args.repeat:
        out["runs"] = [run_variant(torch, mods, frames, card,
                                   f"no wait, event read, run {k + 1}",
                                   False, event_read, 5e-3)[0]
                       for k in range(args.repeat)]
        write(out, args.out)
        return
    if args.after_profiler:
        out["runs"] = []
        for when in ("before", "after"):
            if when == "after":
                profiler_session(torch)
            capture_beside_waits(torch, graphs, card, out, names=(
                "idle", "event read", "event read + 5 ms Python"),
                tag=f" ({when} a profiler session)")
            res, _ = run_variant(torch, mods, frames, card,
                                 f"no wait, event read, {when} a profiler "
                                 f"session", False, event_read, 5e-3)
            out["runs"].append(res)
        write(out, args.out)
        return
    capture_beside_waits(torch, graphs, card, out)
    variants = [("wait", True, tolist_read, 5e-3, False),
                ("wait, event read", True, event_read, 5e-3, False),
                ("no wait", False, tolist_read, 5e-3, False),
                ("no wait, event read", False, event_read, 5e-3, False),
                ("no wait, event read, switch 1 ms", False, event_read, 1e-3,
                 False),
                ("no wait, cProfile on the worker", False, tolist_read, 5e-3,
                 True)]
    out["runs"] = []
    for tag, wait, read, switch, profile in variants:
        res, watch = run_variant(torch, mods, frames, card, tag, wait, read,
                                 switch, profile)
        if tag == "no wait":
            res["standalone"] = standalone(torch, mods, watch, card, False)
        if profile:
            res["standalone"] = standalone(torch, mods, watch, card, True)
            res["profiles"] = []
            for label, secs, prof in watch.profiles:
                if "chunk" not in label:
                    continue
                top = top_functions(prof)
                res["profiles"].append(dict(label=label, seconds=secs,
                                            top=top))
                print(f"[cprofile] {label} ({secs:.3f} s under cProfile): " +
                      "; ".join(f"{t['fn']} {t['tottime']:.3f} s "
                                f"/{t['calls']}" for t in top[:8]))
        out["runs"].append(res)
    write(out, args.out)


def profiler_session(torch):
    """One ``torch.profiler`` session of CUDA activity over a few kernels,
    as ``chip_smoke.py``'s ``device_us`` runs one."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages())
    print(f"[profiler] one session: {n} events recorded")


def write(out, path):
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "out": path}))


if __name__ == "__main__":
    main()
