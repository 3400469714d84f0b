"""The span recorder (``ptam_cg_tpu_torch/utils/spans.py``): host spans at
the engine's boundaries, stage markers in the tracking program, and the
reduction an operator or the benchmark reads.

On the CPU, on tests/test_torch_async.py's scene (320x240, seed 5, 20
frames, auto-init after 6) through the synchronous engine:

- with the recorder off nothing is recorded, and the poses and
  ``FrameInfo``s equal those of the same run with it on, bit for bit;
- with it on, each tracked frame is one ``process_frame`` span that holds
  its children, all of the same frame; the tracking program's stage
  boundaries come in ``STAGES``' order, inside its ``track.replay`` span,
  and the stages sum to the program's span;
- a program captured while the recorder was off gives no stage reading
  (None, not zeros), ``graphs.Graph`` emulated as
  tests/test_torch_map_programs.py emulates it;
- the reduction on hand-made spans: a frame's own host time, the wait,
  the device gap put down to the innermost host span, and that parts sum
  to their wholes.

On the card (``cuda`` marker; skipped without one): the markers inside a
real ``TrackProgram`` graph, and the clock check: under ``torch.profiler``
each replay's first marker follows its launch call, and with its kernels
aligned on its end marker each hand-written kernel (K1, K2, K4, K5) lies
in its stage, in at least 95% of frames. A GPU machine need not have JAX:
run them with
``python -m pytest tests/test_torch_spans.py -m cuda --noconftest``.
"""

import pytest
import torch

from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import synth
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.utils import spans

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
N_FRAMES = 20
#: The tracking program's boundaries, in order: the coarse and the fine
#: search each pass ``select`` to ``pose_gn``.
BOUNDARIES = ["frontend", "sbi_rotation"] + 2 * [
    "select", "templates", "ssd_search", "subpix_refine", "pose_gn"] + [
    "decide", spans.END]
#: How many of each hand-written kernel a tracking replay launches.
KERNEL_COUNTS = {"fast10_atlas_kernel": 1, "sbi_esm_kernel": 1,
                 "gather_kernel": 2, "gather_pair_kernel": 2,
                 "pose_gn_kernel": 2}
CHILDREN = {"engine.read_info", "engine.keyframe", "engine.draws",
            "track.fill", "track.replay", "mapmaker.step", "graph.warm",
            "graph.capture", "spans.read"}


@pytest.fixture
def recorder():
    """The recorder, empty and off before and after the test."""
    spans.disable()
    spans.clear()
    try:
        yield spans
    finally:
        spans.disable()
        spans.clear()


def make_frames(device, n=N_FRAMES):
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=n,
                                  seed=5, height=1.5, radius=0.35,
                                  sweep=1.3, device=device)
    return [seq.frame(i).round().clamp(0, 255).to(torch.uint8)
            for i in range(n)]


def make_engine(device):
    cfg = tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(candidate_min_shi_tomasi_score=70.0))
    return tengine.SLAMEngine(cfg, image_size=SIZE, max_points=1024,
                              max_kfs=8, auto_init_frames=6, seed=0,
                              device=device)


def run_engine(frames, device):
    eng = make_engine(device)
    try:
        return [eng.process_frame(im) for im in frames]
    finally:
        eng.close()


@pytest.fixture(scope="module")
def cpu_runs():
    """The engine's run with the recorder off, then on: (infos off, what
    the recorder held after the run off, infos on, its export)."""
    spans.disable()
    spans.clear()
    try:
        frames = make_frames("cpu")
        off = run_engine(frames, "cpu")
        held_off = spans.export()
        spans.enable()
        on = run_engine(frames, "cpu")
        return off, held_off, on, spans.export()
    finally:
        spans.disable()
        spans.clear()


def test_off_records_nothing_and_changes_nothing(cpu_runs):
    off, held_off, on, _ = cpu_runs
    assert held_off == {"spans": [], "stages": []}
    assert len(off) == len(on) == N_FRAMES
    assert sum(i.stage == "TRACKING" for i in on) > 10
    for a, b in zip(off, on):
        assert torch.equal(a.pose.R, b.pose.R)
        assert torch.equal(a.pose.t, b.pose.t)
        assert a[1:] == b[1:]


def test_each_frame_is_one_span_holding_its_children(cpu_runs):
    _, _, infos, exp = cpu_runs
    roots = [s for s in exp["spans"] if s["name"] == "process_frame"]
    assert [s["frame"] for s in roots] == list(range(N_FRAMES))
    assert all(s["parent"] is None for s in roots)
    assert [s["stage"] for s in roots] == [i.stage for i in infos]
    by_id = {s["id"]: s for s in exp["spans"]}
    root_of = {}
    for s in exp["spans"]:
        if s["name"] == "process_frame":
            continue
        assert s["name"] in CHILDREN, s["name"]
        top = s
        while top["parent"] is not None:
            parent = by_id[top["parent"]]
            assert parent["t0"] <= top["t0"] <= top["t1"] <= parent["t1"]
            top = parent
        assert top["name"] == "process_frame"
        assert s["frame"] == top["frame"]
        root_of.setdefault(top["id"], []).append(s["name"])
    # Every frame tracked since the frame after init fills, draws,
    # replays and runs a mapping pass, once each.
    first = next(k for k, i in enumerate(infos) if i.stage == "TRACKING")
    for s in roots[first + 1:]:
        names = root_of[s["id"]]
        for name in ("engine.draws", "track.fill", "track.replay",
                     "mapmaker.step"):
            assert names.count(name) == 1, (s["frame"], names)


def test_stages_come_in_order_and_sum_to_the_program(cpu_runs):
    _, _, infos, exp = cpu_runs
    replays = {s["frame"]: s for s in exp["spans"]
               if s["name"] == "track.replay"}
    assert len(exp["stages"]) == len(replays) > 10
    for r in exp["stages"]:
        labels = [label for label, _ in r["marks"]]
        times = [t for _, t in r["marks"]]
        assert labels == BOUNDARIES
        assert tuple(dict.fromkeys(labels[:-1])) == spans.STAGES
        assert times == sorted(times)
        replay = replays[r["frame"]]
        assert replay["t0"] <= times[0] <= times[-1] <= replay["t1"]
    red = spans.reduce(exp, 0, 2 ** 63)
    assert red["readings"] == red["frames"] == len(replays)
    assert set(red["stage_ms"]) == set(spans.STAGES)
    assert sum(red["stage_ms"].values()) == pytest.approx(red["graph_ms"],
                                                          rel=1e-9)
    assert sum(red["gap_by_span_ms"].values()) == pytest.approx(
        red["gap_ms"], rel=1e-9)
    # No wait on the CPU: the info vector is already on the host.
    assert red["host_wait_ms"] == 0.0


class _Emulated:
    """``graphs.Graph`` on the CPU: the warm-up, then each replay runs the
    function eagerly on the static buffers, its outputs copied into the
    first replay's."""

    def __init__(self, fn, inputs, debug_path=None, pool=None):
        with graphs.warm():
            fn(*graphs.clone(inputs))
        self.fn, self.inputs, self.outputs = fn, inputs, None
        self.warm_s = self.capture_s = 0.0
        self.launches, self.bodies, self.n_if, self.n_while = {}, [], 0, 0

    def replay(self, name=None):
        with graphs.emulate():
            out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        for buf, x in zip(graphs.tree.tensors(self.outputs),
                          graphs.tree.tensors(out)):
            if buf is not x:
                buf.copy_(x)
        return self.outputs


def test_a_program_captured_while_off_reports_none(recorder, monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _Emulated)
    monkeypatch.setattr(graphs, "on_card", lambda device, g: g)
    frames = make_frames("cpu")
    eng = make_engine("cpu")
    try:
        for im in frames[:10]:
            eng.process_frame(im)
        prog = eng._programs["track"]
        assert prog.graph is not None and prog.marks is None
        recorder.enable()
        for im in frames[10:14]:
            eng.process_frame(im)
    finally:
        eng.close()
    exp = recorder.export()
    assert sum(s["name"] == "track.replay" for s in exp["spans"]) == 4
    assert exp["stages"] == []
    red = recorder.reduce(exp, 0, 2 ** 63)
    assert red["frames"] == 4 and red["readings"] == 0
    for key in ("graph_ms", "stage_ms", "gap_ms", "gap_by_span_ms"):
        assert red[key] is None, key


# -- the reduction on hand-made spans ----------------------------------------

MS = 1_000_000
#: A tracked frame (ms from its start): the frame, the wait for the
#: previous frame's info, the draws, the fills, the replay's launch and
#: the mapping pass.
FRAME = [("process_frame", 0.0, 8.0), ("engine.read_info", 1.0, 4.0),
         ("engine.draws", 4.0, 4.5), ("track.fill", 4.5, 5.0),
         ("track.replay", 5.0, 5.5), ("mapmaker.step", 6.0, 7.0)]
#: Its program's boundaries on the card (ms from the frame's start).
MARKS = [("frontend", 5.5), ("sbi_rotation", 6.0), ("select", 6.5),
         ("templates", 6.7), ("ssd_search", 6.9), ("subpix_refine", 7.1),
         ("pose_gn", 7.6), ("select", 7.7), ("templates", 7.8),
         ("ssd_search", 7.9), ("subpix_refine", 8.0), ("pose_gn", 8.6),
         ("decide", 8.8), (spans.END, 9.0)]


def synthetic_export(n_tracked=3):
    """A frame that captured (before the tracked ones, untracked), then
    ``n_tracked`` tracked frames 10 ms apart."""
    out, ids = [], iter(range(1000))

    def span(name, t0, t1, frame, parent):
        s = dict(id=next(ids), name=name, t0=round(t0 * MS),
                 t1=round(t1 * MS), frame=frame, parent=parent,
                 stage="TRACKING" if name == "process_frame" else None)
        out.append(s)
        return s["id"]

    root = span("process_frame", 0.0, 9.0, 0, None)
    span("graph.warm", 1.0, 2.0, 0, root)
    span("graph.capture", 2.0, 4.5, 0, root)
    stages = []
    for k in range(1, n_tracked + 1):
        base = 10.0 * k
        root = span("process_frame", base, base + 8.0, k, None)
        for name, a, b in FRAME[1:]:
            span(name, base + a, base + b, k, root)
        stages.append({"frame": k, "marks": [[label, round((base + t) * MS)]
                                             for label, t in MARKS]})
    return {"spans": out, "stages": stages}


def test_the_reduction_on_hand_made_spans():
    red = spans.reduce(synthetic_export(), 0, 50 * MS)
    assert red["frames"] == red["readings"] == 3
    assert red["frames_per_s"] == pytest.approx(4 / 0.05)
    # The frame's own host time: 8 ms less the 3 ms wait and the 1 ms pass.
    assert red["host_frame_ms"] == pytest.approx(4.0)
    assert red["host_wait_ms"] == pytest.approx(3.0)
    assert red["mapping_ms"] == pytest.approx(1.0)
    assert red["period_ms"] == pytest.approx(10.0)
    assert red["graph_ms"] == pytest.approx(3.5)
    want = {"frontend": 0.5, "sbi_rotation": 0.5, "select": 0.3,
            "templates": 0.3, "ssd_search": 0.3, "subpix_refine": 1.1,
            "pose_gn": 0.3, "decide": 0.2}
    assert red["stage_ms"] == pytest.approx(want)
    assert sum(red["stage_ms"].values()) == pytest.approx(red["graph_ms"])
    # 9 ms into a frame to 5.5 ms into the next: the 1 ms between frames
    # with no span, 1 ms of the frame's own, the wait, draws, fills and
    # the launch, each to the innermost span.
    assert red["gap_ms"] == pytest.approx(6.5)
    assert red["gap_by_span_ms"] == pytest.approx(
        {"(none)": 1.0, "process_frame": 1.0, "engine.read_info": 3.0,
         "engine.draws": 0.5, "track.fill": 0.5, "track.replay": 0.5})
    assert red["gap_ms"] + red["graph_ms"] == pytest.approx(
        red["period_ms"])
    assert red["capture_s"] == pytest.approx(3.5e-3)
    # An interval without the capturing frame; one without any frame.
    assert spans.reduce(synthetic_export(), 10 * MS, 50 * MS)[
        "capture_s"] == 0.0
    empty = spans.reduce(synthetic_export(), 100 * MS, 200 * MS)
    assert empty["frames"] == 0 and empty["host_frame_ms"] is None
    assert empty["stage_ms"] is None and empty["gap_ms"] is None


def test_a_gap_counts_a_nested_span_once():
    """A wait inside a wait counts once, and goes to the inner one."""
    exp = synthetic_export(2)
    read = next(s for s in exp["spans"] if s["name"] == "engine.read_info"
                and s["frame"] == 2)
    exp["spans"].append(dict(id=999, name="mapmaker.step",
                             t0=read["t0"], t1=read["t0"] + MS, frame=2,
                             parent=read["id"], stage=None))
    red = spans.reduce(exp, 0, 50 * MS)
    assert red["host_frame_ms"] == pytest.approx(4.0)
    assert red["gap_by_span_ms"]["engine.read_info"] == pytest.approx(2.0)
    assert red["gap_by_span_ms"]["mapmaker.step"] == pytest.approx(1.0)
    assert sum(red["gap_by_span_ms"].values()) == pytest.approx(6.5)


def test_kernels_are_binned_by_stage():
    """Each replay's kernels are moved so that its last activity ends at
    its end marker, then binned by their midpoints."""
    r = synthetic_export(1)["stages"][0]
    late = MS // 2        # the profiler's device clock runs 0.5 ms late

    def act(t, name="k"):
        a = round((10 + t) * MS) + late
        return (a, a + 1000, name)
    acts = [act(t) for t in (5.6, 7.05, 7.95, 8.7, 1.0)]
    acts.append(act(8.95, "Memcpy DtoD"))    # the last copy, then `end`
    acts[-1] = (acts[-1][0], round(19 * MS) + late, acts[-1][2])
    counts = spans.by_stage([(r, acts)])
    assert counts == {"frontend": [1, 1000], "ssd_search": [2, 2000],
                      "pose_gn": [1, 1000], "(outside)": [1, 1000]}
    assert spans.stage_at(r["marks"], round(17.95 * MS)) == "ssd_search"
    assert spans.stage_at(r["marks"], round(19.5 * MS)) == "(outside)"


def test_off_sites_record_nothing(recorder):
    with recorder.span("process_frame", 3) as s:
        s.note("TRACKING")
        recorder.add("graph.warm", 0, 1)
        recorder.stage("frontend")
    assert recorder.export() == {"spans": [], "stages": []}
    recorder.enable()
    with recorder.span("process_frame", 3) as s:
        with recorder.span("track.fill"):
            pass
        s.note("TRACKING")
    names = [(x["name"], x["frame"], x["stage"])
             for x in recorder.export()["spans"]]
    assert names == [("track.fill", 3, None),
                     ("process_frame", 3, "TRACKING")]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
def test_markers_inside_the_tracking_graph(cuda, recorder):
    frames = make_frames(cuda)
    recorder.enable()
    eng = make_engine(cuda)
    try:
        infos = [eng.process_frame(im) for im in frames]
        prog = eng._programs["track"]
    finally:
        eng.close()
    assert prog.graph is not None
    assert prog.marks.labels == BOUNDARIES
    assert all(isinstance(e, torch.cuda.Event) for e in prog.marks.times)
    exp = recorder.export()
    tracked = [k for k, i in enumerate(infos) if i.stage == "TRACKING"]
    replays = {s["frame"]: s for s in exp["spans"]
               if s["name"] == "track.replay"}
    assert sorted(r["frame"] for r in exp["stages"]) == sorted(replays)
    assert len(replays) >= len(tracked) - 1 > 10
    for r in exp["stages"]:
        assert [label for label, _ in r["marks"]] == BOUNDARIES
        times = [t for _, t in r["marks"]]
        assert all(b > a for a, b in zip(times, times[1:])), times
        # The card starts the graph after its launch began, which the
        # anchor places within its precision (tens of microseconds).
        assert times[0] > replays[r["frame"]]["t0"] - 100_000
    red = recorder.reduce(exp, 0, 2 ** 63)
    assert sum(red["stage_ms"].values()) == pytest.approx(red["graph_ms"])
    assert red["host_wait_ms"] > 0 and red["recorder_ms"] > 0
    print(red)


@pytest.mark.cuda
def test_markers_are_on_the_profilers_clock(cuda, recorder):
    """Each tracking replay is the graph launch whose call lies inside its
    ``track.replay`` span (``spans.profiled_replays``), and its first
    marker lies after that call began (to the anchor's 100 us). Its
    kernels moved so that its last activity ends at its end marker
    (``spans.aligned``: the profiler's device clock drifts off the host's
    by up to about 1e-3, PERF.md), each hand-written kernel lies in the
    stage that launches it, in at least 95% of frames. The first kernel
    is no witness of the clock: the profiler holds it back after the
    graph starts (0.24-4.2 ms on an H100). The offsets are printed."""
    from torch.profiler import ProfilerActivity, profile
    frames = make_frames(cuda, 2 * N_FRAMES)
    recorder.enable()
    eng = make_engine(cuda)
    try:
        for im in frames[:N_FRAMES]:
            eng.process_frame(im)
        torch.cuda.synchronize()
        recorder.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for im in frames[N_FRAMES:]:
                eng.process_frame(im)
            torch.cuda.synchronize()
    finally:
        eng.close()
    exp = recorder.export()
    pairs = spans.profiled_replays(exp, prof)
    n = len(exp["stages"])
    assert len(pairs) == n >= N_FRAMES - 2
    launch = {s["frame"]: s["t0"] for s in exp["spans"]
              if s["name"] == "track.replay"}
    ends = [r["marks"][-1][1] - max(e for _, e, _ in acts)
            for r, acts in pairs]
    starts = [(r["marks"][0][1] - launch[r["frame"]],
               acts[0][0] - r["marks"][0][1]) for r, acts in pairs]
    print("end marker after the last activity's end, us:",
          [round(x / 1e3, 1) for x in ends])
    print("first marker after the replay's launch; first activity after "
          "the first marker, us:",
          [(round(a / 1e3, 1), round(b / 1e3, 1)) for a, b in starts])
    print("kernels by stage:", spans.by_stage(pairs))
    # The hand-written kernels, each in the stage that launches it.
    placed = spans.placed(pairs)
    assert sum(placed) >= 0.95 * n, placed
    assert all(sum(key in name for _, _, name in kernels) == count
               for _, kernels in spans.aligned(pairs)
               for key, count in KERNEL_COUNTS.items())
    assert sum(a >= -100_000 for a, _ in starts) >= 0.95 * n, starts

