"""The port's engine with ``async_mapping=True``: tracking against published
map snapshots while a worker thread runs the mapping passes (the
reference's two threads, include/MapMaker.h:37-38).

The scene is tests/test_slam_e2e.py's orbit (320x240, 26 frames, seed 5,
height 1.5, radius 0.35, sweep 1.3; 1024 point and 8 keyframe slots,
auto-init after 6 frames, candidate threshold 70), rendered by the port's
synth and rounded to uint8. The bars are tests/test_async_mapping.py's
(more than 10 tracked frames, more than 80% of them GOOD, more than 100
points and at least 2 keyframes once the worker has drained the keyframe
queue, waited for as that test waits) and the e2e's ATE bar (under 5% of
the trajectory's span after a Sim(3) alignment); the synchronous engine
on the same frames is the second witness and meets the same bars.

Then what the JAX engine gets wrong and the port must not: a reset while
a pass is in flight publishes nothing of it and drops the pending
deltas; an exception in the worker is raised by the next
``process_frame``, not only printed; ``close()`` joins the worker. And as
the JAX engine, no tracked frame waits for a capture the worker has under
way; and a reset keeps BA's chunk programs (JAX's chunk compiles are
cached for the process): the MapMaker that a reset makes finds the
program of a key seen before, and captures it no more.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import synth
from ptam_cg_tpu_torch.models import bundle as tbundle
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.utils import evaluate
from ptam_cg_tpu_torch.utils.se3 import SE3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
N_FRAMES = 26


@pytest.fixture(scope="module")
def seq():
    return synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                   n_frames=N_FRAMES, seed=5, height=1.5,
                                   radius=0.35, sweep=1.3, device="cpu")


@pytest.fixture(scope="module")
def frames(seq):
    return [seq.frame(i).round().clamp(0, 255).to(torch.uint8)
            for i in range(N_FRAMES)]


def make_engine(async_mapping=True, **kw):
    cfg = tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(candidate_min_shi_tomasi_score=70.0))
    return tengine.SLAMEngine(cfg, image_size=SIZE, max_points=1024,
                              max_kfs=8, auto_init_frames=6, seed=0,
                              device="cpu", async_mapping=async_mapping,
                              **kw)


def wait_for(cond, seconds=20.0):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


@pytest.mark.parametrize("async_mapping", [True, False],
                         ids=["async", "sync"])
def test_engine_tracks_within_the_bars(seq, frames, async_mapping):
    eng = make_engine(async_mapping)
    try:
        infos = [eng.process_frame(im) for im in frames]
        # Give the worker a moment to drain its keyframe queue, as
        # tests/test_async_mapping.py does.
        assert wait_for(lambda: not eng.mapmaker.kf_queue)
        m = eng.snapshot()
        n_points = int(m.point_valid.sum())
    finally:
        eng.close()
    tracked = [(k, i) for k, i in enumerate(infos) if i.stage == "TRACKING"]
    assert len(tracked) > 10
    assert sum(i.quality == 2 for _, i in tracked) > 0.8 * len(tracked)
    assert n_points > 100 and eng.mapmaker.n_kfs() >= 2
    est = evaluate.camera_centers(SE3(
        torch.stack([i.pose.R for _, i in tracked]),
        torch.stack([i.pose.t for _, i in tracked])))
    gt = np.stack([(-seq.pose(k).R.T @ seq.pose(k).t).numpy()
                   for k, _ in tracked])
    ate = evaluate.ate_rmse(est, gt)
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert ate < 0.05 * max(span, 0.1), (ate, span)


def _tracking_engine(frames, n=9):
    eng = make_engine()
    for im in frames[:n]:
        info = eng.process_frame(im)
    assert info.stage == "TRACKING"
    return eng


def test_reset_during_a_pass_publishes_nothing_of_it(frames):
    """``MapMaker.step`` blocks on an event in the worker; a reset comes
    meanwhile; the pass then ends, and the engine keeps the empty map with
    no delta of the old one, until the next init."""
    eng = _tracking_engine(frames)
    try:
        mm = eng.mapmaker
        entered, release, left = (threading.Event() for _ in range(3))
        real_step = mm.step

        def blocked_step(*a, **kw):
            entered.set()
            assert release.wait(20.0)
            try:
                return real_step(*a, **kw)
            finally:
                left.set()
        mm.step = blocked_step
        eng.process_frame(frames[9])       # wakes the worker
        assert entered.wait(20.0)
        eng.process_frame(frames[10])      # a delta pending for the next pass
        eng.reset()
        assert eng._pending_deltas == []
        release.set()
        assert left.wait(20.0)
        time.sleep(0.2)                    # the pass returns to the worker
        assert eng.stage == tengine.Stage.NOT_STARTED
        assert eng.mapmaker is not mm
        m = eng.snapshot()
        assert int(m.point_valid.sum()) == 0
        assert int(m.point_inlier.abs().sum()) == 0
        assert int(m.point_outlier.abs().sum()) == 0
        infos = [eng.process_frame(im) for im in frames[11:]]
        first = next(k for k, i in enumerate(infos) if i.stage == "TRACKING")
        assert all(i.n_points == 0 and i.n_kfs == 0
                   for i in infos[:first])
        assert infos[first].n_points > 100
    finally:
        eng.close()


def test_worker_exception_is_raised_by_the_next_frame(frames):
    eng = _tracking_engine(frames)

    def failing_step(*a, **kw):
        raise ValueError("mapping pass failed")
    eng.mapmaker.step = failing_step
    eng.process_frame(frames[9])
    assert wait_for(lambda: eng._worker_error is not None)
    with pytest.raises(ValueError, match="mapping pass failed"):
        eng.process_frame(frames[10])
    with pytest.raises(ValueError, match="mapping pass failed"):
        eng.process_frame(frames[11])      # the worker stays stopped
    eng.close()                            # raised already: close is quiet


def test_close_raises_an_unreported_worker_exception(frames):
    eng = _tracking_engine(frames)

    def failing_step(*a, **kw):
        raise ValueError("mapping pass failed")
    eng.mapmaker.step = failing_step
    eng.process_frame(frames[9])
    assert wait_for(lambda: eng._worker_error is not None)
    with pytest.raises(ValueError, match="mapping pass failed"):
        eng.close()


def test_close_joins_the_worker(frames):
    eng = _tracking_engine(frames)
    thread = eng._map_thread
    assert thread.is_alive()
    t0 = time.perf_counter()
    eng.close()
    assert time.perf_counter() - t0 < 10.0
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        eng.process_frame(frames[9])
    eng.close()                            # a second close does nothing


def test_launch_counts_add_up_across_threads():
    """``_build.count_launch`` under threads that interleave often: no
    count is lost (the engine's tracking thread and its worker launch the
    same kernels at once)."""
    import sys
    import types
    from ptam_cg_tpu_torch.kernels import _build
    mod = types.SimpleNamespace(launches=0, launches_by_stream={})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda s=s: [
            _build.count_launch(mod, s) for _ in range(2000)])
            for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert mod.launches == 16000
    assert mod.launches_by_stream == {s: 2000 for s in range(8)}


def _infos_equal(a, b):
    assert torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)
    assert a._replace(pose=None) == b._replace(pose=None)


@pytest.mark.parametrize("hold", ["capture lock", "capture under way"])
def test_frame_does_not_wait_for_a_capture(frames, hold):
    """A thread holds what a capture on the worker holds (the capture
    lock, or a capture counted in for ``graphs.synchronize``) while the
    engine takes its first tracked frame: the frame returns, and its
    ``FrameInfo`` equals that of an engine nobody held up."""
    free = make_engine()
    try:
        want = [free.process_frame(im) for im in frames[:8]]
    finally:
        free.close()
    # Init on frame 6; frame 7 is the first tracked one.
    assert want[5].stage != "TRACKING" and want[6].stage == "TRACKING"
    eng = make_engine()
    held, release = threading.Event(), threading.Event()

    def holder():
        ctx = (graphs._CAPTURE_LOCK if hold == "capture lock"
               else graphs._capture_under_way())
        with ctx:
            held.set()
            release.wait(30.0)
    th = threading.Thread(target=holder)
    got = []
    frame = threading.Thread(
        target=lambda: got.append(eng.process_frame(frames[7])))
    try:
        for im in frames[:7]:
            got.append(eng.process_frame(im))
        th.start()
        assert held.wait(10.0)
        frame.start()
        frame.join(timeout=10.0)
        returned = not frame.is_alive()
    finally:
        release.set()
        th.join(timeout=10.0)
        if frame.ident is not None:
            frame.join(timeout=30.0)
        eng.close()
    assert returned, "the tracked frame waited for the capture"
    assert not th.is_alive() and not frame.is_alive() and len(got) == 8
    for a, b in zip(got, want):
        _infos_equal(a, b)


class _Emulated:
    """``graphs.Graph`` on the CPU (tests/test_torch_map_programs.py's):
    a warm-up on clones of the inputs, then each replay runs the function
    on its capture's path."""

    built = 0

    def __init__(self, fn, inputs, debug_path=None, pool=None):
        _Emulated.built += 1
        with graphs.warm():
            fn(*graphs.clone(inputs))
        self.fn, self.inputs, self.outputs = fn, inputs, None
        self.capture_s, self.launches, self.n_if = 0.0, {}, 0

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


def test_chunk_programs_survive_reset(frames, monkeypatch):
    """The engine's programs as graphs (emulated on the CPU): init's BA
    builds and captures its chunk programs; after ``reset`` the same
    frames initialize again, and the new MapMaker's BA finds the same
    program objects for the same keys, building and capturing none."""
    monkeypatch.setattr(graphs, "Graph", _Emulated)
    monkeypatch.setattr(graphs, "on_card", lambda device, flag: flag)
    built, chunk_init = [], tbundle.ChunkProgram.__init__

    def counted(self, *a, **kw):
        built.append(self)
        chunk_init(self, *a, **kw)
    monkeypatch.setattr(tbundle.ChunkProgram, "__init__", counted)
    eng = make_engine(async_mapping=False)
    infos = [eng.process_frame(im) for im in frames[:7]]
    assert infos[-1].stage == "TRACKING"
    first = dict(eng.mapmaker.programs.chunks)
    assert first and all(p.graph is not None for p in first.values())
    n_built = len(built)
    old_mm = eng.mapmaker
    eng.reset()
    assert eng.mapmaker is not old_mm
    infos = [eng.process_frame(im) for im in frames[:7]]
    assert infos[-1].stage == "TRACKING"
    again = eng.mapmaker.programs.chunks
    assert set(again) == set(first)
    assert all(again[k] is first[k] for k in first)
    assert len(built) == n_built
    assert not [lb for lb, _ in eng.mapmaker.programs.captures
                if lb.startswith("lm_chunk")]
