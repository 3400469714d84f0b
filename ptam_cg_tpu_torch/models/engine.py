"""SLAMEngine: the frame loop (port of ``ptam_cg_tpu.models.engine``).

The reference's System frame loop and the Tracker's state machine
(src/System.cc:54-110, src/Tracker.cc:86-307): each frame goes through
one stage, then (by default on the same thread) through one pass of the
mapping scheduler (``MapMaker.step``), whose queued keyframe aborts a
long BA run between chunks as the reference's abort flag does.

- NOT_STARTED: on an init request (``request_init``, or at once with
  ``auto_init_frames``) the frame's level-0 candidates start trails.
- TRAIL_TRACKING: trails follow each frame; fewer than ``min_trails``
  survivors reset; after ``auto_init_frames`` frames (or on a request)
  ``init_from_stereo`` builds the two-keyframe map, and the engine tracks
  from its second pose. A failed init resets.
- TRACKING: each frame is built and tracked, with the tracker's inlier
  and outlier counts added to the map. Its decisions are deferred one
  frame, as the JAX engine makes them with ``decision_interval=1``: the
  previous frame's info vector ``[quality, lost, n_found, need_kf,
  n_points]`` is read on the host once, at the start of the next frame;
  relocalization (``attempt_recovery`` on that frame's SBI) runs when it
  has been lost for more than ``max_lost_frames``, and a keyframe (a full
  ``build_frame`` of that frame's image) is queued when the heuristics
  ask for one. A BA failure (``MapMaker.reset_requested``) ditches the
  map.

``async_mapping=True`` runs the mapping passes on a worker thread, the
reference's second thread (include/MapMaker.h:37-38), as the JAX engine
restores it (engine.py:227-268): tracking goes on against the last
published map while a pass runs. The MapMaker's jobs write its own map
in place (``MapMaker``'s programs), so each pass adds the tracker's
pending inlier/outlier deltas to that map (first loaded with the
published map when that came from elsewhere: init's), runs
``MapMaker.step`` on it and publishes a copy (``map_state.copy_map``);
no pass writes a map that tracking may read. Unlike the
JAX engine's worker, which runs only when a frame wakes it, the port's
also runs a pass every 50 ms while a keyframe waits or integrates, as
the reference's mapping thread works on between frames: a run whose
frames stop still integrates its last keyframes. On the card
the worker issues its work on its own CUDA stream. The worker captures
the MapMaker's programs of fixed shapes on its first pass
(``MapMaker.capture_jobs``; the synchronous engine on the init frame),
and the others as it meets them (the first time a job runs at a BA tier
or layout, or the first insert); no frame waits for that, as no frame of
the JAX engine waits for the mapping thread's compiles. A tracked frame's
one host read goes through pinned memory and an event (``_read_info``): a
pageable copy to the host held up the worker's CUDA calls, its captures'
among them, for as long as it waited for the card
(``profile_torch_captures.py``). Each hand-off between the threads (the
deltas, a queued keyframe, the map that init made, a published map) makes
the consuming stream wait on an event recorded after the producer's
work, and ``record_stream`` keeps the caching allocator from reusing a
tensor's memory while the other stream may still read it. Unlike the
JAX engine, a reset discards the publication of a pass in flight and the
pending deltas (a generation counter), and an exception in the worker
stops it and is raised by the next ``process_frame`` or by ``close()``,
which joins the worker.

The JAX engine compiles its per-frame work into programs; the port runs
the same three as CUDA graphs on the card (``models/programs.py``): a
tracked frame is one replay of ``TrackProgram`` (its frontend build,
track, the map's new counts and the info vector), a frame build
(``_build``: the trail frames' and a keyframe's) one of ``BuildProgram``,
a relocalization one of ``RelocProgram``. On the CPU, and on the card
with ``graphs=False``, they run eagerly through the same buffers. The
MapMaker's jobs are programs too (``MapMaker(graphs=)``, which the
engine's flag sets). Outside
the tracking replay a tracked frame copies its frame and the 14
``TrackView`` tables in, draws its uniforms into the program's buffers,
reads the info vector once and copies the map's new inlier and outlier
counts out (or, with the worker, the deltas).

Not ported, on purpose: ``decision_interval``, the readiness-gated
decision reads and the ``_inflight`` drain work around a networked TPU,
where every blocking read costs ~20 ms; on a local card one read a frame
is the design.

``mesh`` (a ``parallel.mesh.Mesh``): with more than one rank, global BA
runs point-sharded over the ranks (``MapMaker``'s docstring), init's BA
included. Every rank runs the same engine on the same frames, as JAX's
processes do, and each rank's map stays whole: the sharded solve hands
every rank all the adjusted points. The mapping worker times its passes
by the host, and no value the ranks could share places one rank's passes
where another's are, so a multi-rank mesh refuses ``async_mapping``.

Draws are an input (``Draws``): the engine takes each random draw from one
object, so a parity test can hand in JAX's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import threading
from typing import NamedTuple

import numpy as np
import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import EngineConfig
from ptam_cg_tpu_torch.models import initializer as initlib
from ptam_cg_tpu_torch.models import keyframe as kflib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models import mapmaker as mmlib
from ptam_cg_tpu_torch.models import programs
from ptam_cg_tpu_torch.models import tracker as trklib
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils import spans
from ptam_cg_tpu_torch.utils import tree
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


class Stage(enum.Enum):
    NOT_STARTED = 0          # waiting for an init request
    TRAIL_TRACKING = 1       # between the two init keyframes
    TRACKING = 2             # map good, normal operation


class FrameInfo(NamedTuple):
    pose: SE3                # camera from world (a copy)
    stage: str
    quality: int
    n_found: int
    n_points: int
    n_kfs: int
    added_kf: bool
    relocalized: bool


class Draws:
    """The engine's random draws, from ``torch.Generator``s on ``device``
    seeded as the JAX engine seeds its PRNG keys: the engine's (``seed``)
    draws MLESAC's uniforms and each new tracker stream's seed, the
    tracker's (``seed + 1``) the per-frame coarse and fine uniforms, and
    the MapMaker's (``seed``) the plane aligner's. A replacement needs the
    same five methods; its ``track`` may ignore ``out`` and return its own
    tensors, which the tracking program then copies in."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.seed = seed
        self.device = torch.device(device)
        self._engine = self._generator(seed)
        self._tracker = self._generator(seed + 1)
        self._mapmaker = self._generator(seed)

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _rand(self, g: torch.Generator, shape, out=None) -> Tensor:
        if out is not None:
            return torch.rand(shape, generator=g, out=out)
        return torch.rand(shape, generator=g, device=self.device)

    def rekey_tracker(self):
        """A new tracker stream: after a successful init and at reset."""
        self._tracker = self._generator(int(torch.randint(
            0, 2 ** 62, (), generator=self._engine, device=self.device)))

    def reset_mapmaker(self):
        """The MapMaker is rebuilt with ``seed`` at reset: its stream
        restarts."""
        self._mapmaker = self._generator(self.seed)

    def track(self, P: int, out=None):
        """A tracked frame's (coarse, fine) uniforms, two (P,); drawn into
        ``out`` (two (P,) float32 tensors: the tracking program's uniform
        buffers) when given."""
        out = out or (None, None)
        return (self._rand(self._tracker, P, out[0]),
                self._rand(self._tracker, P, out[1]))

    def mlesac(self, trials: int, n: int) -> Tensor:
        return self._rand(self._engine, (trials, n))

    def plane(self, n_ransacs: int, P: int) -> Tensor:
        return self._rand(self._mapmaker, (n_ransacs, P))


def _copy_pose(pose: SE3) -> SE3:
    return SE3(pose.R.clone(), pose.t.clone())


class SLAMEngine:
    """Frames in (``process_frame``), poses and a growing map out.

    ``deterministic``: True makes the MapMaker's every gate block and its
    BA chunks fixed-size, so a replay gives the same map whatever the
    timing; None picks it on the CPU and latency mode on the card
    (``MapMaker``). ``draws``: the source of every random draw (default
    ``Draws(seed, device)``). ``async_mapping``: run the mapping passes
    on a worker thread (the module's docstring); call ``close()`` when
    done, before the interpreter exits. ``mesh``, ``mesh_axis``: the
    point-sharded global BA's ranks (``MapMaker``); a mesh of more than
    one rank and ``async_mapping`` exclude each other. ``graphs``: False
    runs the programs, the MapMaker's too, eagerly on the card (to
    compare them with their replays); the CPU always runs them eagerly.
    """

    def __init__(self, cfg: EngineConfig = EngineConfig(), image_size=None,
                 max_points: int = 2048, max_kfs: int = 16, seed: int = 0,
                 auto_init_frames: int | None = 6,
                 deterministic: bool | None = None, device="cuda",
                 draws=None, async_mapping: bool = False, mesh=None,
                 mesh_axis: str = "mp", graphs: bool = True):
        trklib.validate_config(cfg.tracker)
        if (async_mapping and mesh is not None
                and mesh.shape[mesh_axis] > 1):
            raise ValueError("async_mapping times its passes by the host; "
                             "a multi-rank mesh needs the synchronous "
                             "engine")
        self.cfg = cfg
        #: The map's atlas dtype, fixed at construction as the JAX
        #: engine's is (bfloat16 under ``cfg.frontend.atlas_bf16``).
        self._atlas_dtype = ms.atlas_dtype(cfg.frontend)
        self.device = torch.device(device)
        self._seed = seed
        self._deterministic = deterministic
        self._capacity = (max_points, max_kfs)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.graphs = graphs
        #: The programs (``models/programs.py``) by kind: "track",
        #: "build", "reloc".
        self._programs = {}
        #: BA's chunk programs, which every MapMaker of the engine uses,
        #: so that a reset keeps them (``mapmaker.ChunkPrograms``).
        self.chunk_programs = mmlib.ChunkPrograms()
        #: Pinned memory for the info vector's host read (``_read_info``).
        self._info_host = None
        self.image_size = tuple(image_size or cfg.camera.image_size)
        self.cam = atan.make_camera(cfg.camera.params, self.image_size,
                                    self.device)
        self.cam_params = torch.tensor(cfg.camera.params, dtype=torch.float32,
                                       device=self.device)
        self.draws = Draws(seed, self.device) if draws is None else draws
        self.auto_init_frames = auto_init_frames
        self.frame_idx = 0
        self.prev_features = None
        self._trail_start_idx = None
        # The mapping worker (async_mapping): everything it shares with
        # tracking (the published map and its event, the pending deltas,
        # the MapMaker, newest_kf, the generation) changes under _map_lock.
        self.async_mapping = async_mapping
        self._map_lock = threading.Lock()
        self._generation = 0
        self._pending_deltas = []
        self._map_stream = (torch.cuda.Stream(self.device)
                            if async_mapping and self.device.type == "cuda"
                            else None)
        self._worker_error = None
        self._error_raised = False
        #: The MapMaker whose fixed-shape jobs the worker has captured.
        self._captured_for = None
        self._closed = False
        self._new_map()
        self._stop_mapping = threading.Event()
        self._mapping_wake = threading.Event()
        self._map_thread = None
        if async_mapping:
            self._map_thread = threading.Thread(
                target=self._mapping_worker, name="mapping", daemon=True)
            self._map_thread.start()

    def _new_map(self):
        """An empty map, a new MapMaker and a new tracker state."""
        P, K = self._capacity
        self.map = ms.empty_map(self.image_size, P, K, self.device,
                                self._atlas_dtype)
        self.mapmaker = mmlib.MapMaker(
            self.map, self.cam, self.image_size, self.cfg.mapmaker,
            self.cfg.bundle, seed=self._seed,
            deterministic=self._deterministic, mesh=self.mesh,
            mesh_axis=self.mesh_axis, graphs=self.graphs,
            chunk_programs=self.chunk_programs)
        self.stage = Stage.NOT_STARTED
        self.tracker_state = trklib.init_tracker_state(device=self.device)
        self.trails = None
        self.first_features = None
        self.frames_since_kf = 0
        self.newest_kf = None
        #: The previous TRACKING frame: its image, tracking output and
        #: info vector, whose decisions this frame makes.
        self._pending = None
        self._prev_sbi_track = None
        self._n_points_host = 0
        self._last_quality = trklib.QUALITY_GOOD
        self._last_n_found = 0
        self._init_requested = self.auto_init_frames is not None
        #: The worker runs passes only on a map that init has made.
        self._mapping_on = False
        #: The event after the published map's writes on the mapping
        #: stream, and the last one the tracking stream waited on.
        self._map_event = None
        self._adopted_event = None
        #: The last map the worker published: the MapMaker's own map
        #: holds the same, so the next pass goes on from it.
        self._published = None

    def request_init(self):
        """The reference's spacebar (src/Tracker.cc:311-347)."""
        self._init_requested = True

    def reset(self):
        """Full reset (Tracker::Reset and the MapMaker's reset). With a
        mapping worker, a pass in flight publishes nothing and the pending
        deltas are dropped."""
        with self._map_lock:
            self._generation += 1
            self._pending_deltas = []
            self._new_map()
        self.draws.reset_mapmaker()
        self.draws.rekey_tracker()

    # -- the mapping worker (async_mapping) ---------------------------------
    def _mapping_worker(self):
        """The mapping thread (MapMaker::run, src/MapMaker.cc:57-114): a
        pass each time tracking wakes it, on the mapping stream on the
        card, and one every 50 ms without a wake while a keyframe waits or
        integrates (the reference's thread works on between frames; the
        JAX engine's waits for the next frame). An exception ends the
        thread and is kept for the tracking thread to raise."""
        with contextlib.ExitStack() as stack:
            if self._map_stream is not None:
                stack.enter_context(torch.cuda.stream(self._map_stream))
            while not self._stop_mapping.is_set():
                if not (self._mapping_wake.wait(timeout=0.05)
                        or self._keyframe_work()):
                    continue
                self._mapping_wake.clear()
                try:
                    self._mapping_pass()
                except Exception as e:   # raised again by the engine
                    self._worker_error = e
                    return

    def _keyframe_work(self) -> bool:
        with self._map_lock:
            return self._mapping_on and self.mapmaker.integrating()

    def _mapping_pass(self):
        """One pass: copy the published map, add the pending deltas, run
        ``MapMaker.step`` on the copy, publish it unless a reset came
        meanwhile (engine.py:252-268 without its reset race)."""
        with self._map_lock:
            if not self._mapping_on:
                return
            gen, mm, newest = self._generation, self.mapmaker, self.newest_kf
            published, deltas = self.map, self._pending_deltas
            self._pending_deltas = []
        if mm is not self._captured_for:
            # The jobs of fixed shapes, before the first job: captured
            # here rather than on the init frame, since no frame waits
            # for the worker.
            mm.capture_jobs()
            self._captured_for = mm
        if published is not self._published:
            mm.map = ms.copy_map(published)
        m = mm.map
        for inl, outl in deltas:
            m.point_inlier += inl
            m.point_outlier += outl
        with spans.span("mapmaker.step"):
            slot = mm.step(newest)
        publish = ms.copy_map(mm.map)
        event = None
        if self._map_stream is not None:
            event = torch.cuda.Event()
            event.record(self._map_stream)
        with self._map_lock:
            if gen != self._generation:
                return
            self.map, self._map_event = publish, event
            self._published = publish
            if slot is not None:
                self.newest_kf = slot

    def _hand_over(self, obj):
        """Tensors the tracking thread made, for the mapping stream: it
        waits for the current stream's work so far, and the allocator
        keeps their memory until the mapping stream's use has run."""
        if self._map_stream is None:
            return
        event = torch.cuda.Event()
        event.record()
        self._map_stream.wait_event(event)
        for t in tree.tensors(obj):
            t.record_stream(self._map_stream)

    def snapshot(self) -> ms.MapState:
        """A map that no later mapping job writes: with a worker, the last
        published one, which the current stream waits for (and keeps
        alive for) once; without, a copy of the map (the MapMaker's jobs
        write theirs in place). Read the map through it, not through
        ``map``, from the tracking thread (a checkpoint, a render)."""
        if not self.async_mapping:
            return ms.copy_map(self.map)
        return self._tracking_map()

    def _tracking_map(self) -> ms.MapState:
        """The map tracking reads now: the MapMaker's without a worker,
        else ``snapshot``'s."""
        if not self.async_mapping:
            return self.map
        with self._map_lock:
            m, event = self.map, self._map_event
        if event is not None and event is not self._adopted_event:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tree.tensors(m):
                t.record_stream(stream)
            self._adopted_event = event
        return m

    def _raise_worker_error(self):
        err = self._worker_error
        if err is not None:
            self._error_raised = True
            raise err

    def close(self):
        """Stop and join the mapping worker (within 10 s); raise its
        exception if no ``process_frame`` has. A synchronous engine has
        nothing to stop."""
        self._closed = True
        thread, self._map_thread = self._map_thread, None
        if thread is not None:
            self._stop_mapping.set()
            self._mapping_wake.set()
            thread.join(timeout=10.0)
            if thread.is_alive():
                raise RuntimeError("the mapping worker did not stop "
                                   "within 10 s")
        if not self._error_raised:
            self._raise_worker_error()

    def __del__(self):
        try:
            self.close()
        except Exception:   # nothing can be raised from a finalizer
            pass

    def _program(self, kind: str, frame_dtype=None) -> programs.Program:
        """The engine's ``kind`` program, a new one when what it bakes in
        (``key_of``) changed."""
        cls = {"track": programs.TrackProgram,
               "build": programs.BuildProgram,
               "reloc": programs.RelocProgram}[kind]
        prog = self._programs.get(kind)
        if prog is None or prog.key != cls.key_of(self.cfg, frame_dtype,
                                                  self._capacity):
            prog = cls(self.cfg, self.image_size, self.cam, self.cam_params,
                       self._capacity, frame_dtype, device=self.device,
                       graphs=self.graphs)
            self._programs[kind] = prog
        return prog

    def _run(self, prog: programs.Program, *args):
        """Call one of the engine's programs (a replay on the card)."""
        return prog(*args)

    def _build(self, im: Tensor) -> kflib.FrameFeatures:
        """The keyframe build of a frame (a copy of the features)."""
        return self._run(self._program("build", im.dtype), im)

    def _read_info(self, info: Tensor):
        """The one host read of a tracked frame's decision scalars. On the
        card it goes through pinned memory and waits on an event: a
        pageable copy (``tolist``) would hold up the mapping worker's CUDA
        calls until the card reached it."""
        if info.is_cuda:
            if self._info_host is None:
                self._info_host = torch.empty(info.shape, dtype=info.dtype,
                                              pin_memory=True)
            self._info_host.copy_(info, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            with spans.span("engine.read_info"):
                done.synchronize()
            spans.synced()
            info = self._info_host
        quality, lost, n_found, need_kf, n_points = info.tolist()
        self._last_quality, self._last_n_found = quality, n_found
        self._n_points_host = n_points
        # Keep the MapMaker's BA size tiers fed with the live point count.
        self.mapmaker._n_points_hint = n_points
        return quality, lost, n_found, need_kf

    def process_frame(self, im) -> FrameInfo:
        """One frame (System::UpdateFrame -> Tracker::TrackFrame): an (H, W)
        uint8 or float32 image, on the host or on the device. The programs
        copy it to the device in its own dtype (from the host without a
        sync) and cast it there. With the span recorder on, the frame is
        a ``process_frame`` span (``utils/spans.py``)."""
        with spans.span("process_frame", self.frame_idx) as s:
            info = self._frame(im)
            s.note(info.stage)
        return info

    def _frame(self, im) -> FrameInfo:
        if self.async_mapping:
            self._raise_worker_error()
            if self._closed:
                raise RuntimeError("process_frame: the engine is closed")
        if not isinstance(im, Tensor):
            im = torch.from_numpy(np.ascontiguousarray(im))
        cfg = self.cfg
        features = None
        if self.stage != Stage.TRACKING:
            features = self._build(im)
        added_kf = relocalized = False
        n_found = 0
        quality = None

        if self.stage == Stage.NOT_STARTED:
            if self._init_requested:
                self.trails = initlib.trail_start(
                    features, self.image_size,
                    cfg.tracker.max_initial_trails)
                self.first_features = features
                self._trail_start_idx = self.frame_idx
                self.stage = Stage.TRAIL_TRACKING
                self._init_requested = False

        elif self.stage == Stage.TRAIL_TRACKING:
            self.trails, n_good = initlib.trail_advance(
                self.trails, self.prev_features, features, self.image_size)
            n_found = int(n_good)
            if n_found < cfg.tracker.min_trails:
                self.reset()
            elif self._init_requested or (
                    self.auto_init_frames is not None
                    and self.frame_idx - self._trail_start_idx
                    >= self.auto_init_frames):
                self._init(features)

        elif self.stage == Stage.TRACKING:
            if self.mapmaker.reset_requested:
                # BA failed numerically: the map is corrupt, ditch it
                # (src/MapMaker.cc:887-892, src/Tracker.cc:67-77).
                self.reset()
                self.frame_idx += 1
                return FrameInfo(
                    pose=se3lib.identity(self.device), stage=self.stage.name,
                    quality=trklib.QUALITY_BAD, n_found=0, n_points=0,
                    n_kfs=0, added_kf=False, relocalized=False)
            relocalized, added_kf = self._track(im)
            quality, n_found = self._last_quality, self._last_n_found

        if features is not None:
            self.prev_features = features
        self.frame_idx += 1
        if quality is not None:
            n_points, q = self._n_points_host, quality
        else:   # not yet tracking, or the frame that initialized
            n_points = int(torch.sum(self.map.point_valid.to(torch.int32)))
            q = int(self.tracker_state.quality)
        return FrameInfo(
            pose=_copy_pose(self.tracker_state.pose), stage=self.stage.name,
            quality=q, n_found=n_found, n_points=n_points,
            n_kfs=self.mapmaker.n_kfs(), added_kf=added_kf,
            relocalized=relocalized)

    def _init(self, features: kflib.FrameFeatures):
        """Stereo init from the first trail frame and this one."""
        cfg = self.cfg
        u_mlesac = self.draws.mlesac(cfg.init.mlesac_trials,
                                     cfg.init.max_matches)
        u_plane = self.draws.plane(cfg.mapmaker.plane_aligner_ransacs,
                                   self._capacity[0])
        self.mapmaker.map = self.map
        pose2 = initlib.init_from_stereo(
            self.mapmaker, self.first_features, features, self.trails,
            u_mlesac, u_plane, cfg.init)
        self.map = self.mapmaker.map
        self._init_requested = False
        if pose2 is None:
            self.reset()
            return
        self.stage = Stage.TRACKING
        self.tracker_state = trklib.init_tracker_state(_copy_pose(pose2))
        self.draws.rekey_tracker()
        self.newest_kf = 1
        self.frames_since_kf = 0
        self._prev_sbi_track = features.sbi_track
        self._pending = None
        self._n_points_host = int(torch.sum(
            self.map.point_valid.to(torch.int32)))
        self.mapmaker._n_points_hint = self._n_points_host
        if not self.async_mapping:
            # The mapping jobs of fixed shapes are captured here, on the
            # init frame, and not on the frames that first run them.
            self.mapmaker.capture_jobs()
        else:
            # Tracking reads a copy; the MapMaker's own map goes on.
            mm = self.mapmaker
            self.map = self._published = ms.copy_map(mm.map)
            self._hand_over((self.map, mm.map, mm.failure_mask,
                             mm.new_point_mask))
            with self._map_lock:
                self._mapping_on = True

    def _track(self, im: Tensor):
        """A TRACKING frame: the previous frame's decisions, this frame's
        build and track, the map's inlier/outlier counts, one mapping
        pass. Returns (relocalized, added_kf)."""
        cfg = self.cfg
        mm = self.mapmaker
        m = self._tracking_map()
        st = self.tracker_state
        p = self._pending
        relocalized = added_kf = False
        self.frames_since_kf += 1
        if p is not None:
            quality, lost, _, need_kf = self._read_info(p["info"])
            # Relocalize if lost (src/Tracker.cc:168-207), from the SBI of
            # the frame whose quality said lost.
            if lost > cfg.tracker.max_lost_frames:
                rr = self._run(self._program("reloc"), m, p["out"].sbi)
                if bool(rr.success):
                    st = dataclasses.replace(
                        st, pose=rr.pose,
                        velocity=torch.zeros_like(st.velocity),
                        just_recovered=torch.ones_like(st.just_recovered),
                        lost_frames=torch.zeros_like(st.lost_frames))
                    self.tracker_state = st
                    relocalized = True
            # Keyframe heuristics for that frame (src/Tracker.cc:146-166).
            if (quality == trklib.QUALITY_GOOD and need_kf
                    and self.frames_since_kf
                    > cfg.tracker.min_frames_between_kfs
                    and mm.queue_size() < cfg.mapmaker.max_queue_size
                    and mm.n_kfs() + mm.queue_size() < m.kf_R.shape[0]):
                # The program's next replay overwrites these: copies go
                # to the queue. p["im"] still holds that frame.
                with spans.span("engine.keyframe"):
                    res, pst = p["out"].result, p["out"].state
                    meas = dict(point=res.meas_point.clone(),
                                pos=res.meas_pos.clone(),
                                level=res.meas_level.clone(),
                                subpix=res.meas_subpix.clone(),
                                valid=res.meas_valid.clone())
                    kf = (self._build(p["im"]), _copy_pose(pst.pose), meas,
                          pst.depth_mean.clone(), pst.depth_sigma.clone())
                    self._hand_over(kf)
                    mm.add_keyframe(*kf)
                self.frames_since_kf = 0
                added_kf = True

        # This frame: the tracking program (build, track, the map's new
        # counts, the decision scalars), its uniforms drawn into its
        # buffers.
        prog = self._program("track", im.dtype)
        P = m.point_pos.shape[0]
        with spans.span("engine.draws"):
            rand_coarse, rand_fine = self.draws.track(P, out=prog.rand)
        fo, new_inl, new_outl, info = self._run(
            prog, st, m, im, self._prev_sbi_track, rand_coarse, rand_fine,
            mm.wiggle_depth_norm)
        res = fo.result
        self.tracker_state = fo.state
        self._prev_sbi_track = fo.sbi_track
        # Let bad-point GC look at the new counts now and then.
        if self.frame_idx % 20 == 0:
            mm.mark_dirty()
        if p is None:
            # The first tracked frame after init reports its own info.
            self._read_info(info)
        self._pending = dict(im=prog.frame, out=fo, info=info)

        if self.async_mapping:
            # The deltas go to the worker's next pass, which it starts now.
            deltas = (res.inlier_delta.clone(), res.outlier_delta.clone())
            self._hand_over(deltas)
            with self._map_lock:
                self._pending_deltas.append(deltas)
            self._mapping_wake.set()
            return relocalized, added_kf
        # One mapping pass.
        mm.map = dataclasses.replace(m, point_inlier=new_inl.clone(),
                                     point_outlier=new_outl.clone())
        with spans.span("mapmaker.step"):
            slot = mm.step(self.newest_kf)
        self.map = mm.map
        if slot is not None:
            self.newest_kf = slot
        return relocalized, added_kf
