"""The engine's compiled programs as CUDA graphs (port of the JAX
engine's jitted programs, ``ptam_cg_tpu/models/engine.py``):

- ``TrackProgram``: ``_track_and_decide`` (engine.py:163-186): the
  frontend build, ``track_frame_from_image``, the map's new inlier and
  outlier counts, ``need_new_kf`` and the info vector ``[quality,
  lost_frames, n_found, need_kf, n_points]``, in one dispatch;
- ``BuildProgram``: ``keyframe.build_frame`` of a frame in its own dtype
  (engine.py:139-141);
- ``RelocProgram``: ``relocalizer.attempt_recovery`` (engine.py:222-224).

Each is a ``graphs.Program``: static input buffers, one CUDA graph
replayed on the card, the same function run eagerly on the same buffers
on the CPU or with ``graphs=False`` (``models/graphs.py``).

A replay overwrites the graph's outputs, so a caller clones what it
keeps past the next call of the same program. ``TrackProgram`` writes
the new tracker state and rotation-estimator SBI into its own input
buffers at the end of the program, as the next frame's inputs, and
returns those buffers; ``BuildProgram`` and ``RelocProgram`` return
clones.

The kernels' launches and the calls a replay stands for are counted as
``models/graphs.py`` sets out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.models import keyframe as kflib
from ptam_cg_tpu_torch.models import map_state as ms
from ptam_cg_tpu_torch.models import mapmaker as mmlib
from ptam_cg_tpu_torch.models import relocalizer as reloclib
from ptam_cg_tpu_torch.models import tracker as trklib
from ptam_cg_tpu_torch.ops import sbi as sbiops
from ptam_cg_tpu_torch.utils import spans
from ptam_cg_tpu_torch.utils import tree

Tensor = torch.Tensor

class Program(graphs.Program):
    """An engine program (``graphs.Program``). ``name``: the function a
    replay counts as a call of. The three programs take the same
    arguments: the engine's config, image size, camera (and its
    parameters), map capacity (points, keyframes) and frame dtype, each
    using what it needs. ``key``: what of them the program bakes in; the
    engine builds a new program when the key changes (the console
    replaces the config)."""

    name = ""

    def __init__(self, cfg, image_size, capacity, frame_dtype, device,
                 graphs: bool, debug_path: str | None):
        super().__init__(device, graphs, debug_path)
        self.key = self.key_of(cfg, frame_dtype, capacity)
        self.cfg = cfg
        self.image_size = tuple(image_size)

    @staticmethod
    def key_of(cfg, frame_dtype, capacity):
        raise NotImplementedError


class TrackOutput(NamedTuple):
    out: trklib.FusedFrameOutput   # state and sbi_track: the input buffers
    point_inlier: Tensor           # (P,) the view's counts plus the deltas
    point_outlier: Tensor
    info: Tensor                   # (5,) int64


def _state_tensors(st: trklib.TrackerState):
    return (st.pose.R, st.pose.t, st.velocity, st.msd_vel, st.lost_frames,
            st.quality, st.just_recovered, st.depth_mean, st.depth_sigma)


class TrackProgram(Program):
    """The tracking program (``_track_and_decide``, engine.py:163-184) at
    one frame dtype and map capacity. Inputs: the frame in its own dtype
    (cast to float32 in the program, as JAX does), the tracker state, the
    previous frame's rotation-estimator SBI, the ``TrackView``'s 14
    tables, the coarse and fine uniforms (``rand``: draw into them) and
    ``wiggle_depth_norm`` (a 0-dim tensor, refilled when the float
    changes). The view's keyframe atlases are in the dtype of
    ``cfg.frontend`` (``map_state.atlas_dtype``), as the frame's atlas
    is. K1 launches once, K2 four times, K4 twice and K5 once a call.

    With the span recorder on (``utils/spans.py``), a call is a
    ``track.fill`` span and a ``track.replay`` span, and the program's
    stage boundaries (``spans.STAGES``) are marked: in the graph, when it
    was captured with the recorder on (``marks``; None otherwise), or by
    host stamps in an eager call."""

    name = "track_frame_from_image"

    def __init__(self, cfg, image_size, cam, cam_params: Tensor, capacity,
                 frame_dtype=torch.float32, device="cuda",
                 graphs: bool = True, debug_path: str | None = None):
        super().__init__(cfg, image_size, capacity, frame_dtype, device,
                         graphs, debug_path)
        W, H = image_size
        dev = self.device
        self.cam, self.cam_params = cam, cam_params
        self.frame = torch.zeros((H, W), dtype=frame_dtype, device=dev)
        self.state = trklib.init_tracker_state(device=dev)
        h, w = (H >> 3) // 2, (W >> 3) // 2
        self.prev_sbi = sbiops.SBI(
            template=torch.zeros((h, w), dtype=torch.float32, device=dev),
            jac=torch.zeros((h, w, 2), dtype=torch.float32, device=dev))
        self.view = trklib.make_track_view(ms.empty_map(
            image_size, *capacity, device=dev,
            atlas_dtype=ms.atlas_dtype(cfg.frontend)))
        self.rand = tuple(torch.zeros(capacity[0], dtype=torch.float32,
                                      device=dev) for _ in range(2))
        self.wiggle = torch.ones((), dtype=torch.float32, device=dev)
        self._wiggle_value = 1.0
        self.marks = None

    @staticmethod
    def key_of(cfg, frame_dtype, capacity):
        return (cfg.tracker, cfg.frontend, ms.atlas_dtype(cfg.frontend),
                cfg.mapmaker.wiggle_scale,
                cfg.mapmaker.max_kf_dist_wiggle_mult, frame_dtype,
                tuple(capacity))

    def _inputs(self):
        return (self.state, self.view, self.frame, self.prev_sbi, self.rand,
                self.wiggle)

    def _fn(self, state, view, frame, prev_sbi, rand, wiggle):
        cfg = self.cfg
        spans.stage("frontend")
        fo = trklib.track_frame_from_image(
            state, view, frame.to(torch.float32), prev_sbi, self.cam,
            self.image_size, self.cam_params, cfg.tracker, cfg.frontend,
            cfg.mapmaker.wiggle_scale, rand_coarse=rand[0],
            rand_fine=rand[1])
        res = fo.result
        need_kf = mmlib.need_new_kf(view, fo.state.pose, fo.state.depth_mean,
                                    wiggle,
                                    cfg.mapmaker.max_kf_dist_wiggle_mult)
        info = torch.stack([x.to(torch.int64) for x in (
            fo.state.quality, fo.state.lost_frames,
            torch.sum(res.meas_valid.to(torch.int32)), need_kf,
            torch.sum(view.point_valid.to(torch.int32)))])
        inl = view.point_inlier + res.inlier_delta
        outl = view.point_outlier + res.outlier_delta
        # The next frame's state and SBI, into this program's inputs.
        for buf, x in zip(_state_tensors(state), _state_tensors(fo.state)):
            buf.copy_(x)
        prev_sbi.template.copy_(fo.sbi_track.template)
        prev_sbi.jac.copy_(fo.sbi_track.jac)
        spans.stage(spans.END)
        out = trklib.FusedFrameOutput(state=state, result=res,
                                      sbi_score=fo.sbi_score, sbi=fo.sbi,
                                      sbi_track=prev_sbi)
        return TrackOutput(out, inl, outl, info)

    def capture(self) -> None:
        if self.graph is None:
            self.marks = (spans.StageMarks(device=True) if spans.enabled
                          else None)
            with spans.marking(self.marks):
                super().capture()

    def run(self):
        if not spans.enabled:
            return super().run()
        if not self.graphs:
            marks = spans.StageMarks(device=False)
            with spans.marking(marks), spans.span("track.replay"):
                out = super().run()
            spans.stamped(marks)
            return out
        self.capture()
        spans.before_replay(self.marks)
        with spans.span("track.replay"):
            out = self.graph.replay(self.name)
        spans.replayed(self.marks)
        return out

    def __call__(self, state: trklib.TrackerState, view, im, prev_sbi,
                 rand_coarse: Tensor, rand_fine: Tensor,
                 wiggle_depth_norm) -> TrackOutput:
        """One frame. ``view``: a ``TrackView`` or a MapState. The
        returned state carries ``state``'s generator."""
        with spans.span("track.fill"):
            for buf, x in zip(_state_tensors(self.state),
                              _state_tensors(state)):
                graphs.fill(buf, x)
            for buf, x in zip(self.view, trklib.make_track_view(view)):
                graphs.fill(buf, x)
            graphs.fill(self.frame, im)
            graphs.fill(self.prev_sbi.template, prev_sbi.template)
            graphs.fill(self.prev_sbi.jac, prev_sbi.jac)
            graphs.fill(self.rand[0], rand_coarse)
            graphs.fill(self.rand[1], rand_fine)
            if isinstance(wiggle_depth_norm, Tensor):
                graphs.fill(self.wiggle, wiggle_depth_norm)
                self._wiggle_value = None
            elif wiggle_depth_norm != self._wiggle_value:
                self.wiggle.fill_(float(wiggle_depth_norm))
                self._wiggle_value = wiggle_depth_norm
        self.state.generator = state.generator
        return self.run()


class BuildProgram(Program):
    """The keyframe build (``build_frame``, engine.py:139-141) of a frame
    in its own dtype, cast to float32 in the program. K1 and K3 launch
    once a call. Returns a clone of the features."""

    name = "build_frame"

    def __init__(self, cfg, image_size, cam=None, cam_params=None,
                 capacity=None, frame_dtype=torch.float32, device="cuda",
                 graphs: bool = True, debug_path: str | None = None):
        super().__init__(cfg, image_size, capacity, frame_dtype, device,
                         graphs, debug_path)
        W, H = image_size
        self.frame = torch.zeros((H, W), dtype=frame_dtype,
                                 device=self.device)

    @staticmethod
    def key_of(cfg, frame_dtype, capacity):
        return (cfg.frontend, ms.atlas_dtype(cfg.frontend),
                float(cfg.mapmaker.candidate_min_shi_tomasi_score),
                frame_dtype)

    def _inputs(self):
        return (self.frame,)

    def _fn(self, frame):
        return kflib.build_frame(
            frame.to(torch.float32), self.cfg.frontend,
            float(self.cfg.mapmaker.candidate_min_shi_tomasi_score))

    def __call__(self, im) -> kflib.FrameFeatures:
        graphs.fill(self.frame, im)
        return graphs.clone(self.run())


class RelocView(NamedTuple):
    """The five MapState tables ``attempt_recovery`` reads."""
    kf_sbi: Tensor             # (K, h_sbi, w_sbi)
    kf_sbi_jac: Tensor         # (K, h_sbi, w_sbi, 2)
    kf_R: Tensor               # (K, 3, 3)
    kf_t: Tensor               # (K, 3)
    kf_valid: Tensor           # (K,)


class RelocProgram(Program):
    """Relocalization (``attempt_recovery``, engine.py:222-224) against
    the map's keyframes at one keyframe capacity. K5 (the ESM) launches
    once a call. Returns a clone of the result."""

    name = "attempt_recovery"

    def __init__(self, cfg, image_size, cam=None, cam_params=None,
                 capacity=(1, 1), frame_dtype=None, device="cuda",
                 graphs: bool = True, debug_path: str | None = None):
        super().__init__(cfg, image_size, capacity, frame_dtype, device,
                         graphs, debug_path)
        W, H = image_size
        self.sbi_size = ((H >> 3) // 2, (W >> 3) // 2)
        self.cam_params = cam_params
        m = ms.empty_map(image_size, 1, capacity[1], device=self.device)
        self.view = RelocView(*(getattr(m, f) for f in RelocView._fields))
        self.sbi = sbiops.SBI(template=torch.zeros_like(m.kf_sbi[0]),
                              jac=torch.zeros_like(m.kf_sbi_jac[0]))

    @staticmethod
    def key_of(cfg, frame_dtype, capacity):
        return (cfg.reloc, capacity[1])

    def _inputs(self):
        return (self.view, self.sbi)

    def _fn(self, view, sbi):
        return reloclib.attempt_recovery(
            view, sbi, self.cam_params, self.sbi_size,
            self.cfg.reloc.max_score, self.cfg.reloc.esm_iterations)

    def __call__(self, m, cur_sbi: sbiops.SBI) -> reloclib.RelocResult:
        """``m``: a MapState (or anything with ``RelocView``'s fields)."""
        for f, buf in zip(RelocView._fields, self.view):
            graphs.fill(buf, getattr(m, f))
        graphs.fill(self.sbi.template, cur_sbi.template)
        graphs.fill(self.sbi.jac, cur_sbi.jac)
        return graphs.clone(self.run())
