"""Run the PyTorch port's tracking step, keyframe integration, bundle
adjustment, stereo init, relocalization, the engine (with and without its
mapping worker), the dataset entry point, point-sharded BA over
torch.distributed, the meshed engine and the calibrator on one NVIDIA
GPU.

    python3 chip_smoke.py

(``python3 chip_smoke.py --rank R --world W --port P --job ba|engine
--dir D`` is one rank of phase 14 or 15, which the script starts
itself.)

Phases, each fatal on failure:
1. device: the card's name and power limit; build the six CUDA kernels
   (``ptam_cg_tpu_torch/csrc``) and phase 2c's variants of K3 with nvcc
   for sm_90a, one nvcc each, all at once;
2. K1 (FAST-10) against its plain PyTorch version over the pyramid atlas
   of a 640x480 frame, in one launch: mask atlas, scores and per-level
   counts bit-identical, with and without the scores; and K1 on one
   640x480 image (a table of one level, ``ops/fast.detect``, off the
   engine's path): mask and score bit-identical, ``detect`` on the card
   equal to the CPU's;
2b. K3 (Shi-Tomasi) over the pyramid atlas of the 640x480 frame and over
   an atlas with bright borders in every level and in the unused area,
   in one launch: bit-identical; and the host time a call of the K3 and
   K2 wrappers (and of the wrapper's parts), over 200 back-to-back calls;
2c. K3's tile-shape variants (off the main path): each built with its
   ``-D`` defines, bit-identical on both atlases, timed on the 640x480
   atlas (profiler device us, two rounds in opposite orders);
3. K2 (window gather) against its plain version at the window shapes of
   the tracking and keyframe paths, f32 and bool, int64 and int32 origin
   columns, strided and contiguous, and the pair entry (image and mask
   windows in one launch) at the three search shapes: bit-identical; and
   the bootstrap path's shapes: the trail search pair (D=29, M=21), the
   9x9 MiniPatch and 8x8 template cuts.
   Phases 2-3 time every path call: CUDA events (kernel, plain version,
   and for K2 the one PyTorch call that computes the same windows, an
   unfolded view indexed at the origins), device time from torch.profiler,
   and the bound (bytes over the HBM rate or float32 operations over the
   float32 peak, the larger: K1 reads the levels' pixels, K2 the source
   bytes under at least one window, each once), with the launches a
   frame and a keyframe;
4. tracking: a 2048-point planar map, then ``track_frame_from_image`` on
   frames 1..60 of the sequence. Every frame must be GOOD, within 0.02 in
   camera centre and 0.01 rad in rotation, and the kernels' launch counts
   must equal the calls the step makes times 60 (1 K1, 4 K2, 2 K4,
   1 K5 and 2 K6 a frame);
2d. (after phase 4, on its frames) K4 (the Gauss-Newton pose loop), K5
   (the SBI ESM alignment) and K6 (the sub-pixel refinement) against
   their plain versions on the
   inputs the step gives them on phase 4's 60 frames (rerun with the
   same seed, each frame's start velocity above the coarse gate, as
   phase 5's): K4's coarse call (N=128) and final call (N=1152), K5 on
   each frame's and its predecessor's 30x40 SBIs. Bars: K4's pose within
   1e-5, its weights within ``K4_W_TOL`` (scaled by 16 / sigma^2), equal
   zero-weight sets but where the other run's weight is at most 1e-10
   (err^2 within 1e-5 of sigma^2); K5's R and t within 1e-5 and score
   within 1e-4 relative; two launches bit-identical; each printed
   beside the measured differences, with device us, the bound (counted
   on each call's data: K4's iterations and found points, K5's masked
   pixels), CUDA-event ms and the plain version's ms. K5 also at the
   SBIs of 1280x720 and 1920x1080 frames (45x80, 67x120: more than 48 kB
   of shared memory), against its plain version at the same bars. K6's
   coarse call (N=128, 40x40 windows) and fine call (N=1024, 30x30), 8
   iterations each: positions within 1e-4 px, the last step's length
   within 2e-4 px plus 1e-5 of it, equal converged sets but where the
   last step is at the
   convergence limit (``utils/parity.py``), two launches bit-identical;
   timed as K4, its bound counted on each call's data (the iterations
   each point updates, the window bytes under its taps);
5. the same frame, uniforms and start state (with the coarse stage on)
   through the port on the card and on the CPU: the same found set up to
   differences traced to float noise (under 1% of found points), and a
   pose within 1e-5;
6. the keyframe path: a map of frame 0's Shi-Tomasi candidates
   (``candidate_map_scene``, 2048 slots, 4 keyframe slots); track frames
   1..40; ``need_new_kf``; ``build_frame`` and ``integrate_keyframe_program``
   on frame 40 with its tracker measurements; new points must lie on the
   z=0 plane (median |z| < 0.02) and frames 41..60 must track GOOD within
   the phase-4 bars against the grown map, finding some new points. The
   launch counts of the whole phase must equal those the code makes
   (the keyframe: 1 K1, 1 K3, 14 K2 and 5 K6).
   ``build_frame`` and the integration are timed;
7. the integration of phase 6 on the card and on the CPU from the same
   map, features and measurements: the same re-found set and new points
   per level up to differences traced to float noise (at most 1%), new
   points within 1e-3 and measurements within 1e-3 px;
8. bundle adjustment (no hand-written kernel): ``bench_ba.py``'s problem
   (``synth.ba_problem``, points perturbed) at the local (5 cameras, 512
   points, 2048 measurements) and global (64, 4096, 16384) tiers, TF32
   off. As bench_ba has it (one fixed camera): ``compute`` twice on the
   card, bit-identical. With a second camera fixed to pin the scale
   (``ba_tier``): one LM step from the start, card against the CPU port,
   the same flags and pruned set; ``compute`` on the card twice,
   bit-identical; against the CPU port (and the CPU port on one thread,
   for the spread summation order alone makes) the same failed flag and
   pruned set, the RMS within a relative BA_ERR_RTOL. Step and run: poses
   and points within the BA_* bars. The RMS falls. Timed: ``lm_step`` and
   ``compute`` by CUDA events and the host clock, device us and kernels a
   step (profiler), host reads a step and a run (sync debug mode: one a
   lambda try, and one a problem), peak memory, and the dominant Schur
   product against its bound; and the largest difference between the
   card's and the CPU's ATAN projection of the problem's points, in ulps
   of the pixel coordinate and in px;
9. the MapMaker's BA (deterministic mode): global BA, then local BA of
   the newest keyframe, on ``synth.ba_map``'s 64 keyframes in 128 slots
   and 4096 point slots, twice on the card (bit-identical), once in the
   card's default mode (latency mode: the same map) and on the CPU (the
   same point-valid, measurement, retry and never-retry masks, poses and
   valid points within phase 8's bars); then global BA and
   ``handle_bad_points`` on a copy of phase 6's integrated map (keyframe
   0 fixed, as stereo init fixes it; ``_n_points_hint`` set to the live
   count, as the engine sets it), the same card-vs-CPU bars, frames
   41..60 tracked GOOD at phase 4's bars against the adjusted map, and
   the number of phase 6's wrong epipolar points (|z| > 0.05) that BA
   pruned, printed;
10. the bootstrap path on tests/test_slam_e2e.py's orbit (seed 5, height
   1.5, radius 0.35, sweep 1.3, 26 frames) at full width, with the
   engine's capacities (2048 point and 16 keyframe slots), 300 MLESAC
   trials on up to 1024 matches: ``build_frame`` and trail tracking on
   frames 0..6, ``init_from_stereo`` on frames 0 and 6 (it must succeed,
   and the map's points lie on the aligned plane: median |z| < 0.02 of
   the scene depth), then ``track_frame_from_image`` from the returned
   pose on frames 7..25, every frame GOOD, each frame's rotation relative
   to frame 0 within 0.01 rad of the truth and the camera path within
   0.02 of it after a similarity alignment. The launch counts of trail
   tracking and init must equal those the code makes. The card against
   the CPU port: trails per frame from the same trails (the same good set
   and positions up to differences traced to float noise, under 1%), the
   homography from the same matches and uniforms (the same success and
   inliers, H within 1e-4), and init from the same trails and uniforms
   (both succeed; point sets within 1%; keyframe 1's pose, the points
   and wiggle_depth_norm, scaled by keyframe 1's |t|, within the INIT_*
   bars); the CPU on one thread gives the spread that summation order
   alone makes. Then
   relocalization: frame 7 tracked from the identity pose is lost;
   ``attempt_recovery`` must pick the keyframe nearest the truth and
   succeed, card = CPU, and the frame tracked from its pose is GOOD.
   Timed: ``trail_advance`` a frame, ``homography.compute``, the whole
   ``init_from_stereo`` with its BA-run count, and ``attempt_recovery``.
11. the engine, ``SLAMEngine.process_frame``, on bench_engine.py's 240
   frames at 640x480 (uint8 from the host), replaying its programs and
   its MapMaker's as CUDA graphs (phases 17-18): 11a deterministic, 11b
   card against CPU, 11c the card's latency mode (frame latency, FPS,
   host reads, busy share; then the same frames with the MapMaker's
   programs run eagerly, and the first ``ENG_ALL_EAGER`` with every
   program run eagerly, p50, p95, max and FPS beside the graphed ones), 11d relocalization (each also
   run eagerly on its inputs) and the poisoned-map reset (also with the
   MapMaker's programs eager; the captures after the reset, none of them
   a chunk graph of a key captured before it: the engine keeps its chunk
   programs across a reset), 11e
   tests/test_slam_e2e.py's orbit at its pace, where integrations add
   points, card against CPU, and the card with the MapMaker's programs
   eager (equal in outcome). 11c, 11d and 12 print the default
   engine's p50, p95, max and FPS beside ``MapMaker(graphs=False)``'s and
   beside the numbers PERF.md records from before frames stopped waiting
   for the worker's captures (``BEFORE``); every engine outcome's digest
   (``outcome_digest``) compares runs frame for frame;
12. the engine with its mapping worker (``async_mapping=True``) on the
   same frames in latency mode: the bars of tests/test_async_mapping.py
   and the e2e's ATE, its latency, FPS, mapping passes, map copies (and
   one copy's device time) and busy share beside 11c's, and the kernels'
   launches by CUDA stream (K2's integration launches on the mapping
   stream, the rest on the tracking thread's), each capture the worker
   made (label, seconds) with the latencies of the tracked frames it
   overlapped that capture nothing themselves (a capture of
   ``CAPTURE_HOLD_S`` or more must outlast every one: no frame waits for
   it), then the programs run eagerly beside;
   12b: 11e's orbit with the worker (the map grows), a reset while a
   pass is in flight (the map stays empty until the next init) and
   ``close()`` within 10 s;
13. the dataset entry point: 11e's first 60 frames written as a TUM
   dataset (``io/tum.py``), read by the native frame pump (each frame
   equal to its file), and ``apps.run_tum`` with ``--native``, a settings
   file, a console script, a checkpoint (equal to the final map), a map
   render and AR frames; ``apps.run_synthetic --async-mapping``;
14. point-sharded global BA (``parallel/sharded_ba.py``, no kernel) at
   tests/test_sharded_ba.py::make_problem_large's full width (128
   keyframes, 16,384 points, 65,536 measurements): 2 ranks on the card
   over gloo (two processes of this script, started with ``--rank``),
   against the one-process ``bundle.compute`` on the card: one LM step
   within JAX's at-scale bars (the same iterations and accepts, error
   within a relative 1e-3, poses within 2e-4, points' 99th percentile
   within 2e-3, over 99.9% of pruned flags equal), the whole run's RMS
   under 0.05 px and within 0.02 px of the one-process run's, the
   points within a median 5e-3 of the truth, both ranks bit-identical;
   ``compute_sharded`` with NCCL on 1 rank to the same bars; a 2-rank
   checkpoint after the first chunk resumed on the NCCL rank; ms a chunk
   (CUDA events), the floats each collective moves and the share of the
   chunks' host time spent in collectives;
15. the engine with a 2-rank mesh (gloo, both ranks on the card) on
   11e's orbit: the ranks' FrameInfos and launch counts identical,
   global BA sharded, the outcome equal to 11e's card run within its
   bars, K1-K6's launches equal to those the calls make, a tracked
   frame's p50 and p95 beside 11e's;
16. ``apps.run_calib --synthetic 5`` at 640x480 on the card: RMS under
   0.3 px, the parameters within tests/test_calibrator.py's bars, the
   CPU port's grid of view 0 (from the card's image) and its joint
   optimization from the card's grids within CALIB_* of the card's;
   ``apps.make_synth_tum --nonplanar`` (60 frames) then ``apps.run_tum
   --native`` on it, ATE under 8% of the span
   (tests/test_slam_nonplanar.py's bar);
17. the engine's programs (``models/programs.py``) as CUDA graphs
   against the same programs run eagerly on the card: the tracking
   program on phase 4's 60 frames (pose, found set, info vector and the
   new counts bit for bit, or within eager's own run-to-run spread,
   which is printed), the keyframe build on phase 6's keyframe frame
   (every field), the relocalizer on 11d's relocalizations; each graph
   holds the K1-K6 launches its capture recorded (counted in its
   Graphviz dump) and its capture called no plain version. Each
   program's capture s, graph nodes against an eager call's kernels, a
   replay's ms by CUDA events and by the host clock and device us, the
   eager call's beside; the 14 TrackView copies' device us; and a
   tracked frame's launches and copies outside its one graph replay;
18. the MapMaker's programs (``MapPrograms``: the JAX MapMaker's jitted
   jobs) and BA's LM chunk (``bundle.ChunkProgram``) as CUDA graphs with
   conditional nodes (WHILE for a loop, IF for a branch), against the
   same programs run eagerly on the card (``MapMaker(graphs=False)``),
   bit for bit: phase 6's integration after each of its five phases (every map
   field, the new-point mask, slot and points added; each graph holds the K2
   launches its capture recorded,
   and the phase's launches equal its calls'); a span re-find on 11e's
   grown map of BA's failure queue and every other keyframe's unmeasured
   points (some slots with work, some without; the re-finds and K2
   launches of the bodies that ran equal the eager calls'); local
   BA's masks and extraction at the local tier, its chunks and
   write-back, global BA at the global tier, GC and the plane alignment
   on phase 9's 64-keyframe map; the LM chunk on phase 8's tiers in
   chunks of one iteration, five and all, a state at lambda's floor and
   a blown solve (``failed``), in state and flags, with a step's retries
   inside a graph, and one host read a chunk against one a try eagerly
   (sync debug mode). Each program's capture s, nodes and conditional
   nodes (its dump), a replay's ms by CUDA events and the host clock and
   device us, the eager call's beside; each MapMaker's captures and
   memory pool; and two LM chunk graphs captured at once on two threads
   (as the engine's two threads may), each replay equal to the eager
   chunk bit for bit.
   11c, 11e and 12 also run the engine with ``MapMaker(graphs=False)``
   (and 11c, 12 with every program eager, on their first
   ``ENG_ALL_EAGER`` frames): p50, p95, max, keyframe frames and FPS
   beside the graphed run's; 11e's MapMaker runs equal in
   outcome;
19. the bf16 frontend configuration (``FrontendConfig(atlas_bf16=True)``,
   ``TrackerConfig(zmssd_bf16_cross=True)``): K2's bf16-source
   instantiation (bf16 atlas, float32 windows) bit-identical to its
   plain version at every path shape of phase 3, timed as phase 3 times
   K2 (its library call: the unfolded bf16 view indexed, then cast, two
   calls); ``SLAMEngine.process_frame`` under the configuration on
   phase 11's 240 frames: 19b deterministic (every tracked frame GOOD,
   11a's bars, launch counts, every K2 launch reading a bf16 atlas), 19c
   card = CPU in outcome through two scheduler-integrated keyframes
   (11b's bars), 19d latency mode (p50, p95, FPS beside 11c's); the
   map's bytes and a ``copy_map`` (a worker pass's copy), float32 and
   bf16.
Phase 14 also runs the 2-rank ``compute_sharded`` with the sharded step's
stretches eager (``graphs=False``): 14e, replay = eager bit for bit on
each rank, chunk ms of both.
The line before the last is a JSON summary of the kernels (numbers summed
over a tracked frame's calls (K4's two), K3's over a keyframe's; K2's bf16
instantiation as ``gather_windows_bf16``, its launches phase 19's;
``launches_by_stream_async``: phase 12's launches by CUDA stream); the
last line is the JSON result. Times are medians of CUDA-event timings.
"""

import dataclasses
import faulthandler
import json
import statistics
import subprocess
import sys
import threading
import time
import warnings

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (640, 480)
N_FRAMES = 60
N_TRACK_KF = 40      # phase 6: the frame that becomes a keyframe
CAND_MIN = 50.0      # bench_mapping.py's candidate threshold
POSE_TOL = 1e-5
POS_TOL = 1e-3
REPS = 25
INT_REPS = 10
KERNELS = ("fast10", "gather_windows", "shi_tomasi", "pose_gn", "sbi_esm",
           "subpix")
#: The CUDA graphs' conditional-node helper (``csrc/graph_cond.cu``): no
#: kernel of the path, built with the kernels.
GRAPH_COND = "graph_cond"
# Phase 2c: K3's tile shapes (output columns x rows a block, pixels a
# thread along x); () is the default build, the keyframe path's.
ST_VARIANTS = ((), ("ST_TILE_H=32",), ("ST_PX=1",),
               ("ST_TILE_W=32", "ST_PX=1"), ("ST_TILE_W=128", "ST_PX=4"))
HOST_CALLS = 200
DETECT_CAP = 1024    # phase 2: ops/fast.detect's corner list
# The bound of a kernel call: H100 SXM HBM rate and float32 peak outside
# the tensor cores (NVIDIA's data sheet, at 700 W); one add, subtract,
# compare, min, max, multiply, divide or root counts as one operation.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# K3's float32 operations a pixel: 2 gradients, 3 products, 3 x (6 + 6)
# box-sum adds, 3 divides, 11 for the smaller eigenvalue.
SHI_OPS = 55
# K4's float32 operations an iteration: for every point (projection 34,
# error 7), and for each point found and projected at that iteration's
# pose (weight 4, camera derivatives 22, pose Jacobian 85, scaling 24,
# normal equations 108); the median's comparisons are not counted. K5's:
# the warp of every pixel (25), and for each pixel inside the border with
# its four neighbours' warps valid, gradients and residual 13, sums 30.
GN_OPS_ALL, GN_OPS_OK = 41, 243
ESM_OPS_ALL, ESM_OPS_OK = 25, 43
# K6's float32 operations: a point's preamble (gradients 144, H's sums
# 288, the 3x3 inverse 45), and each iteration it updates (bounds and
# window tests 28, blend weights 6, for each of 36 samples the blend 7,
# the difference 2 and J^T d 5, the update 15, position, mean and step 7).
SUBPIX_OPS_PRE, SUBPIX_OPS_IT = 477, 560
# Phase 2d: K4's weights against the plain version's at sigma^2 = 16,
# scaled by 16 / sigma^2 (tests/test_torch_pose_kernels.py: 1.2e-5
# measured there at 16 on an H100); a zero weight against a nonzero one
# only where the nonzero one is at most ZERO_W_MAX (err^2 within 1e-5 of
# sigma^2 for Tukey, w = (1 - err^2 / sigma^2)^2).
K4_W_TOL = 2e-5
ZERO_W_MAX = 1e-10
SE2_TOL = 1e-5
# Phase 8: BA tiers (cameras, points, measurements), bench_ba.py's.
BA_TIERS = {"local": (5, 512, 2048), "global": (64, 4096, 16384)}
BA_REPS = 5
# Phase 9: synth.ba_map's keyframes, slots and points.
BA_MAP = dict(n_kfs=64, max_kfs=128, n_pts=4096, seed=0)
# Card against CPU (see ba_tier): poses, and points by their 99th
# percentile and their largest difference; the RMS error, relative. Each
# is 2-3x the larger of two spreads measured on one H100 at 700 W: card
# against CPU, and the CPU port on 1 against 8 threads (PERF.md §6):
# poses 3.8e-5 (one step), points 2.2e-3 (99th percentile) and 5.3e-3
# (largest), RMS 4.9e-5.
BA_POSE_TOL = 1e-4
BA_PT_P99_TOL = 5e-3
BA_PT_MAX_TOL = 1e-2
BA_ERR_RTOL = 1.5e-4
WRONG_Z = 0.05       # a new point further off the z=0 plane is wrong
# Phase 10: tests/test_slam_e2e.py's orbit and candidate threshold; trails
# run on frames 0..N_TRAIL (the e2e's auto-init after 6 frames).
INIT_SEQ = dict(n_frames=26, seed=5, height=1.5, radius=0.35, sweep=1.3)
N_TRAIL = 6
INIT_CAND_MIN = 70.0
INIT_MAP = dict(max_points=2048, max_kfs=16)   # the engine's capacities
LOST_FRAME = 7
# Card against CPU init, after dividing by keyframe 1's |t| (the scale is
# free): keyframe 1's pose, the points by their 99th percentile, and
# wiggle_depth_norm times |t|, relative. Each is ~3x the larger of two
# spreads measured on one H100 at 700 W (PERF.md §6): card against CPU,
# and the CPU port on 1 against 8 threads: pose 2.3e-6, points 1.9e-6,
# wiggle norm 1.8e-7.
INIT_POSE_TOL = 7e-6
INIT_PT_P99_TOL = 6e-6
INIT_WIGGLE_RTOL = 5e-7
# Phase 11: bench_engine.py's scene and engine (its 240 frames, uint8 on
# the host), and the reloc test's orbit for 11d.
ENG_SEQ = dict(n_frames=240, seed=7, height=1.5, radius=0.35, sweep=1.3)
ENG_CAND_MIN = 100.0
ENG_MAP = dict(max_points=4096, max_kfs=16, auto_init_frames=6, seed=0)
RELOC_SEQ = dict(n_frames=16, seed=5, height=1.5, radius=0.35, sweep=1.3)
# 11e: tests/test_slam_e2e.py's orbit at its own pace (1.3 rad over 25
# frame steps) run on to 76 frames, past three keyframes: unlike
# bench_engine.py's slow orbit, its keyframes' epipolar search adds points.
GROW_SEQ = dict(n_frames=76, seed=5, height=1.5, radius=0.35, sweep=3.9)
# 11e: card against CPU over all 76 frames, poses as in 11b. Its 8
# global BA runs turn their accept counts on float noise (phase 8), so a
# GC pass may land a frame apart and the poses drift further than 11b's:
# ~3x the larger of the two spreads measured on one H100 at 700 W
# (PERF.md §6): card against CPU (|dR| 2.67e-5, |dt| 1.23e-4), and the
# CPU port on 1 against 8 threads (2.65e-5, 1.22e-4).
GROW_ROT_TOL = 8e-5
GROW_T_TOL = 4e-4
# Phase 13: 11e's first frames, written as a TUM-layout dataset.
DATASET_FRAMES = 60
ENG_PROFILE = 20     # 11c, 12: the last frames, under the profiler
# Phase 14: tests/test_sharded_ba.py::make_problem_large at full width.
SHARD_BA = dict(n_cams=128, n_pts=16384, obs_per_pt=4, seed=7)
SHARD_RANKS = 2
RANK_DEADLINE = 600  # s: a rank past it is killed and its phase fails
# Phase 16: card against the CPU port's calibrator (the CPU tests measure
# 1.5e-5 px between the packages' grids, 5e-6 between their parameters).
CALIB_GRID_TOL = 1e-3
CALIB_PARAM_TOL = 1e-4
NONPLANAR_FRAMES = 60
ENG_SYNC = 10        # 11c: the frames before them, under sync debug mode
#: 11c, 12: the frames the engine with every program eager runs (the
#: first ones; its host-bound frames make it the slowest variant).
ENG_ALL_EAGER = 100
#: 12: a worker capture at least this long (s) must outlast every tracked
#: frame it overlapped (a frame that waited for it would last as long),
#: but the init frame and a frame that captures a program of its own;
#: shorter ones are printed only, since a frame outlasts them either way.
CAPTURE_HOLD_S = 0.1
#: The engine's numbers as PERF.md section 5 records them from its run
#: "f2" (one H100 80GB HBM3 at 700.00 W), made while a tracked frame
#: waited for the mapping worker's captures: (p50 ms, p95 ms, max ms,
#: FPS), None where not recorded; the default engine and
#: ``MapMaker(graphs=False)``.
BEFORE = {"11c": {"default": (22.4, 41.6, 1319.0, 24.86),
                  "MapMaker eager": (20.4, 48.2, 641.3, 33.50)},
          "11d": {"default": None, "MapMaker eager": None},
          "12": {"default": (24.5, 47.1, None, 14.77),
                 "MapMaker eager": (32.0, 44.9, None, 26.78)}}
ENG_CPU1 = 16        # 11b: frames the CPU runs on one thread (the spread)
# 11b: card against CPU, each frame's rotation and translation over |t|
# on the init frame (the scale is free): ~3x the larger of the measured
# card-vs-CPU and 1-vs-8-thread spreads (|dR| 2.55e-5 and 9.80e-6, |dt|
# 1.51e-6 and 5.03e-7 on one H100, PERF.md §6).
ENG_ROT_TOL = 8e-5
ENG_T_TOL = 5e-6
# 11b and 19c on a run whose found counts differ from the CPU's on some
# tracked frame: there a threshold decision went the other way (a point
# found or not, or found elsewhere), which moves the poses around it by
# more than rounding does. ~3x the largest spread measured on such runs,
# |dR| 1.77e-4 and |dt| 1.75e-4, which the path before K6 (the plain
# sub-pixel loop on the card) reads against the CPU as K6 does, on the draw
# seed whose runs part by a point at frame 37 (engine_parity.py, PERF.md
# §6); and the found counts within 1% (as tests/test_torch_bf16.py holds
# them against JAX's).
ENG_ROT_TOL_FOUND = 6e-4
ENG_T_TOL_FOUND = 6e-4
ENG_FOUND_RTOL = 0.01


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def time_ms(fn, torch, reps=REPS, setup=None):
    """Median over ``reps`` CUDA-event timings of one call, after a
    warm-up. ``setup`` makes each call's argument, outside the timing."""
    setup = setup or (lambda: None)
    fn(setup())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_rows(prof):
    """(name, self device us, count) of a profile's kernel rows: only rows
    of the card's own events, since a host row that launched a kernel
    carries the same device time."""
    from torch.autograd import DeviceType
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            yield e.key, e.self_cuda_time_total if t is None else t, e.count


def device_us(fn, torch, n=20, match=None, setup=None, tries=3):
    """Device time (us) and kernels per call from torch.profiler over
    ``n`` calls, counting only kernels whose name holds ``match`` if
    given. The profiler now and then records no kernel for a short run;
    up to ``tries`` runs are made. (None, 0) when none recorded one."""
    from torch.profiler import ProfilerActivity, profile
    def arg():
        return setup() if setup else None

    fn(arg())
    for _ in range(tries):
        args = [arg() for _ in range(n)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(a)
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for key, t, calls in device_rows(prof):
            if t > 0 and (match is None or match in key):
                total += t
                count += calls
        if count:
            return total / n, count / n
    return None, 0


def host_us(fn, torch, n=HOST_CALLS):
    """Host time (us) a call over ``n`` back-to-back calls and one sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def bordered_atlas(size, seed, dev):
    """A pyramid atlas whose levels hold noise inside a 3-px border of 0
    with bright dots (255) one pixel in from each edge, in an unused area
    of 0 with bright dots: a score that read across a level's edge, or
    any nonzero score outside the levels' inner pixels, would differ."""
    import numpy as np
    import torch
    from ptam_cg_tpu_torch.kernels import fast as kfast
    w, h = size
    r = np.random.default_rng(seed)
    shape = (h * 3 // 2, w)
    atlas = np.where(r.uniform(size=shape) < 0.01, 255.0, 0.0).astype(
        np.float32)
    for (r0, c0, hl, wl) in kfast.level_rects(shape):
        lev = np.zeros((hl, wl), np.float32)
        lev[3:-3, 3:-3] = r.uniform(0, 120, (hl - 6, wl - 6))
        lev[[1, -2], 2:-2:5] = 255.0
        lev[2:-2:5, [1, -2]] = 255.0
        atlas[r0: r0 + hl, c0: c0 + wl] = lev
    return torch.from_numpy(atlas).to(dev)


def fmt_us(us):
    return "not measured" if us is None else f"{us:.2f} us"


def max_abs_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def fast_work(pyramid, thresholds, torch):
    """What K1's arithmetic needs on these levels: the pixels at least
    3 px inside a level (each takes c+t, c-t, 8 compass compares and the
    corner test: 11 operations), and the (pixel, polarity) pairs with two
    or more compass pixels beyond the threshold (each takes 64 doubling
    min/max, 15 more over the 16 arcs, a subtract and a max: 81)."""
    n_inner = n_polar = 0
    for im, t in zip(pyramid, thresholds):
        c = im[3:-3, 3:-3]
        H, W = c.shape
        compass = [im[3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W]
                   for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        bright = sum(((r - (c + t)) > 0).int() for r in compass)
        dark = sum((((c - t) - r) > 0).int() for r in compass)
        n_inner += c.numel()
        n_polar += int((bright >= 2).sum()) + int((dark >= 2).sum())
    return n_inner, n_polar


def covered(shape, oy, ox, D):
    """Elements of an (H, W) source under at least one D x D window at the
    clamped (oy, ox) origins: the bytes a gather must read, each once."""
    import torch
    H, W = shape
    oy = oy.clamp(0, H - D)
    ox = ox.clamp(0, W - D)
    edges = torch.zeros(H + 1, W + 1, dtype=torch.int32, device=oy.device)
    ones = torch.ones_like(oy, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (D, 0, -1), (0, D, -1), (D, D, 1)):
        edges.index_put_((oy + dy, ox + dx), sign * ones, accumulate=True)
    return int((edges.cumsum(0).cumsum(1)[:H, :W] > 0).sum())


def sync_count(fn, torch):
    """Host syncs PyTorch's sync debug mode reports during ``fn()``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def ba_diffs(torch, R, t, pts, R_c, t_c, pts_c):
    """(|d pose|, 99th percentile and max of |d point|), card against
    CPU."""
    d_pose = max(max_abs_diff(R.cpu(), R_c), max_abs_diff(t.cpu(), t_c))
    d_pt = (pts.cpu() - pts_c).abs().max(dim=1).values
    return d_pose, float(torch.quantile(d_pt, 0.99)), float(d_pt.max())


def ba_within(d):
    d_pose, p99, d_max = d
    return (d_pose <= BA_POSE_TOL and p99 <= BA_PT_P99_TOL
            and d_max <= BA_PT_MAX_TOL)


def fmt_d(d):
    return (f"|d pose| {d[0]:.2e}, |d point| 99th percentile {d[1]:.2e}, "
            f"max {d[2]:.2e}")


def ba_repeats(torch, tier, prob, cam):
    """bench_ba's own problem (one fixed camera): two card runs must be
    bit-identical and lower the RMS."""
    from ptam_cg_tpu_torch.models import bundle
    runs = [bundle.compute(prob, cam, return_flags=True) for _ in range(2)]
    (a, _, fa), (b, _, fb) = runs
    same = fa == fb and all(torch.equal(getattr(a.problem, f),
                                        getattr(b.problem, f))
                            for f in ("cam_R", "cam_t", "pt_pos", "meas_bad"))
    rms0 = float(bundle.residual_rms(prob, cam))
    rms1 = float(bundle.residual_rms(a.problem, cam))
    print(f"[8] BA {tier}, bench_ba's problem (camera 0 fixed): runs "
          f"(converged, iterations, failed, accepted) {fa}; RMS "
          f"{rms0:.4f} -> {rms1:.4f} px; two card runs bit-identical: {same}")
    check(same and torch.equal(a.last_error, b.last_error),
          f"BA {tier}, one fixed camera: two card runs differ")
    check(not fa[2] and rms1 < rms0, f"BA {tier}, one fixed camera: failed "
          f"{fa[2]}, RMS {rms0} -> {rms1}")


def atan_ulps(torch, tier, c_prob, c_cam, cam, card):
    """The card's and the CPU's ATAN projection of the same z=1-plane
    points (the problem's measurements' points, projected on the CPU):
    the largest difference in ulps of the pixel coordinate (over the
    coordinates of at least 1 px: near 0 an ulp is no measure of a
    pixel), the largest difference in px, and how many points differ."""
    from ptam_cg_tpu_torch.camera import atan
    mc, mp = c_prob.meas_cam.long(), c_prob.meas_pt.long()
    p_cam = ((c_prob.cam_R[mc] @ c_prob.pt_pos[mp][..., None])[..., 0]
             + c_prob.cam_t[mc])
    z1 = p_cam[:, :2] / p_cam[:, 2:3]
    pix_c = atan.project(z1, c_cam)
    pix_g = atan.project(z1.to(cam.focal.device), cam).cpu()
    diff = (pix_g - pix_c).abs()
    mag = torch.maximum(pix_c.abs(), pix_g.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    ulps = torch.where(mag >= 1.0, diff / ulp, 0.0)
    worst = float(ulps.max())
    at = int(torch.argmax(ulps.max(dim=1).values))
    print(f"[8] ATAN projection of {z1.shape[0]} points ({tier}), card vs "
          f"CPU: largest difference {worst:.0f} ulps of the coordinate (at "
          f"radius {float(z1[at].norm()):.3f} on the z=1 plane, pixel "
          f"{pix_c[at].tolist()}), {float(diff.max()):.3e} px at most, "
          f"{int((diff > 0).any(dim=1).sum())} points differ  [{card}]")
    return worst


def ba_tier(torch, dev, card, tier, C, P, M):
    """Phase 8 at one tier: card runs, card vs CPU, times and counts.

    bench_ba's problem runs first, as it is (``ba_repeats``). For the
    comparisons the problem fixes a second camera, C // 2, far from the
    first: bench_ba's single fixed camera leaves the monocular scale free,
    and card and CPU then drift apart along it. One LM step from the start is
    held to the same flags and pruned set. A whole run (10-20 steps)
    decides some steps on float noise (an accept whose error change is
    noise; a lambda retry after the float32 Schur complement goes
    indefinite near lambda's 1e-10 floor), so its iteration and accept
    counts may differ; it is held to its outcome: the same failed flag
    and pruned set, the RMS within a relative BA_ERR_RTOL. Poses and
    points must agree within BA_POSE_TOL and BA_PT_*_TOL, in the step and
    in the run; a point seen in one or two near-parallel views moves
    most. The CPU port on one thread, against its default threads, shows
    the spread summation order alone makes."""
    from ptam_cg_tpu_torch.config import BundleConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import bundle
    from ptam_cg_tpu_torch.utils import mest
    from ptam_cg_tpu_torch.utils.tree import to_device
    ba_repeats(torch, tier, *synth.ba_problem(C, P, M, seed=0, device=dev))
    prob, cam = synth.ba_problem(C, P, M, seed=0, fixed=(0, C // 2),
                                 device=dev)
    c_prob, c_cam = to_device(prob, "cpu"), to_device(cam, "cpu")
    rms0 = float(bundle.residual_rms(prob, cam))
    atan_ulps(torch, tier, c_prob, c_cam, cam, card)

    # One step, card against CPU.
    s0 = bundle.init_lm(prob)
    g1, c1 = bundle.lm_step(s0, cam), bundle.lm_step(bundle.init_lm(c_prob),
                                                     c_cam)
    f1 = bundle.flags(g1)

    def diffs(x, y):
        x, y = x.problem, y.problem
        return ba_diffs(torch, x.cam_R, x.cam_t, x.pt_pos, y.cam_R, y.cam_t,
                        y.pt_pos)

    d1 = diffs(g1, c1)
    print(f"[8] BA {tier}: one step, card vs CPU: flags {f1} / "
          f"{bundle.flags(c1)}, {fmt_d(d1)}")
    check(f1 == bundle.flags(c1) and torch.equal(g1.problem.meas_bad.cpu(),
                                                 c1.problem.meas_bad),
          f"BA {tier}: one step's flags or pruned set differ")
    check(ba_within(d1), f"BA {tier}: one step's poses or points differ")

    # Whole runs: twice on the card, on the CPU, and on one CPU thread.
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, n, flags = bundle.compute(prob, cam, return_flags=True)
        torch.cuda.synchronize()
        runs.append((state, flags, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() - base
    (a, fa, sa), (b, fb, sb) = runs
    same = fa == fb and all(torch.equal(getattr(a.problem, f),
                                        getattr(b.problem, f))
                            for f in ("cam_R", "cam_t", "pt_pos", "meas_bad"))
    check(same and torch.equal(a.last_error, b.last_error),
          f"BA {tier}: two card runs differ")
    conv, iters, failed, accepted = fa
    rms1 = float(bundle.residual_rms(a.problem, cam))
    check(not failed and rms1 < rms0, f"BA {tier}: failed {failed}, RMS "
          f"{rms0} -> {rms1}")
    cpu = []
    n_threads = torch.get_num_threads()
    for threads in (n_threads, 1):
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        c_state, _, c_flags = bundle.compute(c_prob, c_cam, return_flags=True)
        cpu.append((c_state, c_flags, time.perf_counter() - t0,
                    float(bundle.residual_rms(c_state.problem, c_cam))))
    torch.set_num_threads(n_threads)
    (c, fc, cpu_s, rms_c), (c1t, fc1, _, rms_c1) = cpu
    d = diffs(a, c)
    d_cpu = diffs(c1t, c)
    d_rms = abs(rms1 - rms_c) / rms_c
    print(f"[8] BA {tier} C={C} P={P} M={M}, cameras 0 and {C // 2} fixed: "
          f"RMS {rms0:.4f} -> {rms1:.4f} px; two card runs bit-identical. "
          f"Runs (converged, iterations, failed, accepted): card {fa}, CPU "
          f"{fc} ({n_threads} threads), CPU {fc1} (1 thread); "
          f"{int(a.problem.meas_bad.sum())} pruned; card vs CPU {fmt_d(d)}, "
          f"RMS rel. {d_rms:.2e}; CPU 1 vs {n_threads} threads "
          f"{fmt_d(d_cpu)}, RMS rel. {abs(rms_c1 - rms_c) / rms_c:.2e}; CPU "
          f"compute {cpu_s:.2f} s")
    check(not fc[2] and torch.equal(a.problem.meas_bad.cpu(),
                                    c.problem.meas_bad),
          f"BA {tier}: card and CPU runs pruned differently or failed")
    check(ba_within(d) and d_rms <= BA_ERR_RTOL,
          f"BA {tier}: card and CPU runs differ")

    # Times and counts of one LM step from the start state, and of a run.
    tries = f1[1]
    step_ms = time_ms(lambda _: bundle.lm_step(s0, cam), torch,
                      reps=BA_REPS)
    host = []
    for _ in range(BA_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.lm_step(s0, cam)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    dev_us_step, n_kernels = device_us(lambda _: bundle.lm_step(s0, cam),
                                       torch, n=3)
    reads = sync_count(lambda: bundle.lm_chunk(
        s0, cam, BundleConfig(), mest.TUKEY, 1, bundle.INIT_FLAGS), torch)
    run_reads = sync_count(lambda: bundle.compute(prob, cam), torch)
    check(reads == tries and run_reads == iters + 1,
          f"BA {tier}: host reads {reads} in a step of {tries} lambda tries, "
          f"{run_reads} in a run of {iters} iterations")
    run_ms = time_ms(lambda _: bundle.compute(prob, cam), torch, reps=3)
    # The dominant product, S_off = (W V^-1)(W)^T: (6C x 3P)(3P x 6C).
    flops = 2.0 * (6 * C) ** 2 * 3 * P
    bound_us = flops / F32_OPS_S * 1e6
    wv = torch.rand(6 * C, 3 * P, device=dev)
    w = torch.rand(6 * C, 3 * P, device=dev)
    mm_ms = time_ms(lambda _: wv @ w.T, torch)
    print(f"[8] BA {tier}: lm_step from the start ({tries} lambda "
          f"tries): {step_ms:.3f} ms (CUDA events), host "
          f"{statistics.median(host) * 1e3:.3f} ms; device "
          f"{fmt_us(dev_us_step)} in {n_kernels:.0f} kernels; host reads "
          f"(sync debug mode) in a one-step chunk {reads}, in a run "
          f"{run_reads} (one a lambda try, one for the layout); compute {run_ms:.3f} ms (CUDA events), host "
          f"{sa * 1e3:.3f} / {sb * 1e3:.3f} ms ({iters} iterations); peak "
          f"memory {peak / 2 ** 20:.1f} MiB above the problem; Schur "
          f"product {2 * (6 * C) ** 2 * 3 * P / 1e9:.3f} GFLOP a lambda "
          f"try: bound {bound_us:.2f} us (f32 peak), matmul alone "
          f"{mm_ms * 1e3:.2f} us (CUDA events)  [{card}]")


def ba_compare_makers(torch, gpu, cpu, what):
    """Card MapMaker against CPU MapMaker after the same BA: the masks
    that differ (none allowed) and the pose and point differences."""
    masks = [f for f in ("point_valid", "meas_valid", "never_retry")
             if not torch.equal(getattr(gpu.map, f).cpu(), getattr(cpu.map, f))]
    if not torch.equal(gpu.failure_mask.cpu(), cpu.failure_mask):
        masks.append("retry")
    g, c = gpu.map, cpu.map
    live = c.point_valid
    d = ba_diffs(torch, g.kf_R, g.kf_t, g.point_pos[live.to(g.point_pos.device)],
                 c.kf_R, c.kf_t, c.point_pos[live])
    return masks, d


def check_makers(masks, d, what):
    check(not masks, f"{what}: card and CPU differ in {masks}")
    check(ba_within(d), f"{what}: card and CPU poses or points differ")


def _global_rms(torch, mp, cam):
    from ptam_cg_tpu_torch.models import bundle, mapmaker
    prob, *_ = mapmaker.extract_bundle(mp, mp.kf_valid & ~mp.kf_fixed,
                                       mp.kf_valid & mp.kf_fixed,
                                       mp.point_valid,
                                       int(mp.meas_valid.sum()))
    return float(bundle.residual_rms(prob, cam))


def run_ba(torch, mp, cam, calls, deterministic=True):
    """A MapMaker on ``mp`` (deterministic unless asked otherwise; the
    live point count as its hint) after ``calls`` (each takes the maker);
    returns (maker, host seconds of each call)."""
    from ptam_cg_tpu_torch.models import mapmaker
    maker = mapmaker.MapMaker(mp, cam, SIZE, deterministic=deterministic)
    maker._n_points_hint = int(mp.point_valid.sum())
    seconds = []
    for call in calls:
        t0 = time.perf_counter()
        call(maker)
        if mp.point_pos.is_cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        check(not maker.reset_requested, "BA requested a map reset")
    return maker, seconds


def ba_mapmaker_64(torch, dev, card):
    """Phase 9 on synth.ba_map: global then local BA."""
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.utils.tree import to_device
    m64, cam = synth.ba_map(**BA_MAP, image_size=SIZE, device=dev)
    newest = BA_MAP["n_kfs"] - 1
    calls = [lambda mk: mk.bundle_adjust_all(),
             lambda mk: mk.bundle_adjust_recent(newest)]
    rms0 = _global_rms(torch, m64, cam)
    a, secs = run_ba(torch, m64, cam, calls)
    b, _ = run_ba(torch, m64, cam, calls)
    # The card's default: latency mode, chunks sized by the step time.
    lat, lat_secs = run_ba(torch, m64, cam, calls, deterministic=None)
    check(not lat.deterministic and lat._ba_step_ms is not None,
          "phase 9: the card's default MapMaker did not run latency mode")
    for other, what in ((b, "two card runs"),
                        (lat, "deterministic and latency mode")):
        for f in ("kf_R", "kf_t", "point_pos", "point_valid", "meas_valid",
                  "never_retry"):
            check(torch.equal(getattr(a.map, f), getattr(other.map, f)),
                  f"phase 9: {what} differ in {f}")
        check(torch.equal(a.failure_mask, other.failure_mask),
              f"phase 9: {what} differ in the retry mask")
    rms1 = _global_rms(torch, a.map, cam)
    t0 = time.perf_counter()
    c, _ = run_ba(torch, to_device(m64, "cpu"), to_device(cam, "cpu"), calls)
    cpu_s = time.perf_counter() - t0
    masks, d = ba_compare_makers(torch, a, c, "phase 9 (64 keyframes)")
    print(f"[9] 64-keyframe map: {int(m64.point_valid.sum())} points, "
          f"{int(m64.meas_valid.sum())} measurements; global BA "
          f"{secs[0] * 1e3:.1f} ms, local BA of keyframe {newest} "
          f"{secs[1] * 1e3:.1f} ms (host clock); {a._last_n_sel} "
          f"measurements in the last extract; converged full "
          f"{a.converged_full}, recent {a.converged_recent}; RMS "
          f"{rms0:.4f} -> {rms1:.4f} px; points valid "
          f"{int(a.map.point_valid.sum())}, retry "
          f"{int(a.failure_mask.sum())}, never-retry "
          f"{int(a.map.never_retry.sum())}; two card runs bit-identical, "
          f"and latency mode (global {lat_secs[0] * 1e3:.1f} ms, local "
          f"{lat_secs[1] * 1e3:.1f} ms, step EMA {lat._ba_step_ms:.2f} ms); "
          f"card vs CPU: masks differing {masks}, {fmt_d(d)}; CPU "
          f"{cpu_s:.2f} s  [{card}]")
    check_makers(masks, d, "phase 9 (64 keyframes)")
    check(rms1 < rms0, "phase 9: BA did not lower the error")


def ba_mapmaker_phase6(torch, card, mk2, new_mask, cam, cpu_cam):
    """Phase 9 on a copy of phase 6's integrated map: global BA and GC.
    Returns the card's adjusted map."""
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.utils.tree import to_device
    m6 = ms.copy_map(mk2)
    m6.kf_fixed[0] = True
    wrong = new_mask & (m6.point_pos[:, 2].abs() > WRONG_Z)

    def calls(mk):
        mk.bundle_adjust_all()
        mk.handle_bad_points()

    rms0 = _global_rms(torch, m6, cam)
    a, secs = run_ba(torch, m6, cam, [calls])
    c, _ = run_ba(torch, to_device(m6, "cpu"), cpu_cam, [calls])
    masks, d = ba_compare_makers(torch, a, c, "phase 9 (phase-6 map)")
    rms1 = _global_rms(torch, a.map, cam)
    pruned = int((wrong & ~a.map.point_valid).sum())
    print(f"[9] phase 6's map: {int(m6.point_valid.sum())} points, "
          f"{int(m6.meas_valid.sum())} measurements; global BA + GC "
          f"{secs[0] * 1e3:.1f} ms (host clock); RMS {rms0:.4f} -> "
          f"{rms1:.4f} px; points valid {int(a.map.point_valid.sum())}, "
          f"retry {int(a.failure_mask.sum())}, never-retry "
          f"{int(a.map.never_retry.sum())}; card vs CPU: masks differing "
          f"{masks}, {fmt_d(d)}; wrong epipolar points (|z| > {WRONG_Z}): "
          f"{int(wrong.sum())}, pruned by BA {pruned}  [{card}]")
    check_makers(masks, d, "phase 9 (phase-6 map)")
    return a.map

def host_ms(fn, torch, reps=REPS):
    """Median over ``reps`` host-clock timings of one synchronized call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def similarity_align(src, dst):
    """Umeyama: the scale s, rotation R and shift t that best map the
    (N, 3) points ``src`` onto ``dst`` (numpy, float64)."""
    import numpy as np
    ms_, md = src.mean(0), dst.mean(0)
    a, b = src - ms_, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(a * a, axis=1))
    return s, R, md - s * R @ ms_


def init_outcome(torch, mk):
    """A finished init's map, scale-free: (point-valid mask, keyframe 1's
    R, its t over |t|, points over |t|, wiggle_depth_norm times |t|), on
    the CPU."""
    m = mk.map
    t1 = m.kf_t[1].cpu()
    n = float(torch.linalg.vector_norm(t1))
    return (m.point_valid.cpu(), m.kf_R[1].cpu(), t1 / n,
            m.point_pos.cpu() / n, mk.wiggle_depth_norm * n)


def init_diffs(torch, a, b):
    """(point-valid differences, |d R|, |d t|, 99th percentile of |d
    point| over the points valid in both, relative d wiggle norm) of two
    ``init_outcome``s."""
    va, vb = a[0], b[0]
    both = va & vb
    d_pt = (a[3][both] - b[3][both]).abs().max(dim=1).values
    return (int((va != vb).sum()), max_abs_diff(a[1], b[1]),
            max_abs_diff(a[2], b[2]), float(torch.quantile(d_pt, 0.99)),
            abs(a[4] - b[4]) / abs(b[4]))


def fmt_init(d):
    return (f"point-valid differences {d[0]}, keyframe 1 |dR| {d[1]:.2e} "
            f"|dt| {d[2]:.2e}, points 99th percentile {d[3]:.2e}, "
            f"wiggle norm rel. {d[4]:.2e}")


def bootstrap(torch, dev, card, kernels, reset_counts, counts):
    """Phase 10: trail tracking, stereo init, tracking from the new map,
    card against CPU, relocalization."""
    import numpy as np
    from ptam_cg_tpu_torch.config import (InitConfig, MapMakerConfig,
                                          TrackerConfig)
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import homography, initializer
    from ptam_cg_tpu_torch.models import keyframe as kflib
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.models import mapmaker, relocalizer, tracker
    from ptam_cg_tpu_torch.utils import parity, se3
    from ptam_cg_tpu_torch.utils.tree import to_device

    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                  **INIT_SEQ)
    W, H = SIZE
    n_frames = INIT_SEQ["n_frames"]
    frames = [seq.frame(i) for i in range(n_frames)]
    cam_params = torch.tensor(REF_PARAMS, device=dev)
    cpu_cam = to_device(seq.cam, "cpu")
    icfg, mm_cfg = InitConfig(), MapMakerConfig()
    max_trails = TrackerConfig().max_initial_trails
    gen = torch.Generator().manual_seed(10)
    u_mlesac = torch.rand((icfg.mlesac_trials, icfg.max_matches),
                          generator=gen)
    u_plane = torch.rand((mm_cfg.plane_aligner_ransacs,
                          INIT_MAP["max_points"]), generator=gen)

    def build(im):
        return kflib.build_frame(im, candidate_min_score=INIT_CAND_MIN)

    def new_maker(device, cam):
        return mapmaker.MapMaker(ms.empty_map(SIZE, device=device,
                                              **INIT_MAP), cam, SIZE, seed=0)

    def delta(before):
        return {n: c - before[n] for n, c in counts().items()}

    # ---- trail tracking on frames 0..N_TRAIL ----
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ffs = [build(frames[0])]
    trails = [initializer.trail_start(ffs[0], SIZE, max_trails)]
    diags, n_good = [], []
    for i in range(1, N_TRAIL + 1):
        ffs.append(build(frames[i]))
        d = {}
        tr, n = initializer.trail_advance(trails[-1], ffs[i - 1], ffs[i],
                                          SIZE, diag=d)
        trails.append(tr)
        diags.append(d)
        n_good.append(int(n))
    trail_s = time.perf_counter() - t0
    trail_counts = counts()
    n_start = int(trails[0].valid.sum())
    print(f"[10] {W}x{H}, candidates a level in frame 0 "
          f"{ffs[0].cand_valid.sum(-1).tolist()}; {trails[0].valid.shape[0]}"
          f" trails, {n_start} valid at the start; good after each frame "
          f"{n_good}; {trail_s * 1e3:.1f} ms for 7 builds and 6 advances "
          f"(host clock); launches {trail_counts}")
    # Each build: K1 and K3 once; the start cuts the MiniPatches (K2);
    # each advance: the forward search pair, the backward cut and the
    # backward search pair (K2).
    per_trail = {"fast10": 1, "shi_tomasi": 1, "gather_windows": 3,
                 "pose_gn": 0, "sbi_esm": 0, "subpix": 0}
    want = {name: 1 + N_TRAIL * n if n else 0
            for name, n in per_trail.items()}
    check(trail_counts == want, f"trail-tracking launch counts differ from "
          f"{want}")
    check(n_good[-1] >= 0.5 * n_start > 50, f"too few trails survive: "
          f"{n_good}")

    # ---- stereo init ----
    mk = new_maker(dev, seq.cam)
    stats = {}
    before = counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    with CallCounts([(mapmaker, "add_points_epipolar")]) as init_calls, \
            k6_recorder(torch) as k6_calls:
        pose2 = initializer.init_from_stereo(
            mk, ffs[0], ffs[-1], trails[-1], u_mlesac.to(dev),
            u_plane.to(dev), icfg, stats=stats)
        end.record()
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    init_ev = start.elapsed_time(end)
    init_counts = delta(before)
    hres = stats["homography"]
    check(pose2 is not None, "stereo init failed on the card")
    m = mk.map
    n_pts = int(m.point_valid.sum())
    n_epi = int(mk.new_point_mask.sum())
    depth = float(m.kf_depth_mean[0])
    z = m.point_pos[m.point_valid, 2].abs() / depth
    z_epi = m.point_pos[mk.new_point_mask & m.point_valid, 2].abs() / depth
    med_z = float(z.median())
    print(f"[10] init from frames 0 and {N_TRAIL}: homography "
          f"{int(hres.n_inliers)} inliers of {n_good[-1]} matches; "
          f"{n_pts} points ({n_epi} from the epipolar expansion), "
          f"{stats['n_ba']} BA runs; scene depth {depth:.4f}; |z| / depth: "
          f"median {med_z:.2e} (epipolar points "
          f"{float(z_epi.median()) if n_epi else float('nan'):.2e}), 90th "
          f"percentile {float(torch.quantile(z, 0.9)):.2e}; "
          f"wiggle_depth_norm {mk.wiggle_depth_norm:.5f}; {init_ms:.1f} ms "
          f"(host clock), {init_ev:.1f} ms (CUDA events); launches "
          f"{init_counts}  [{card}]")
    # Init: the 8x8 template cuts and the sub-pixel windows (K2), then per
    # epipolar level templates, corner patches and sub-pixel windows: 4
    # levels, each graph's warm-up call (phase 18) besides.
    n_levels = init_calls.n["add_points_epipolar"]
    want_init = {"fast10": 0, "shi_tomasi": 0,
                 "gather_windows": 2 + 3 * n_levels, "pose_gn": 0,
                 "sbi_esm": 0, "subpix": 1 + n_levels}
    check(n_levels in (4, 8), f"init ran {n_levels} epipolar levels, not 4 "
          f"(and a warm-up each if captured)")
    check(init_counts == want_init, f"init launch counts differ from "
          f"{want_init}")
    check(med_z < 0.02, f"init's points are off the aligned plane: median "
          f"|z| / depth {med_z}")

    # ---- tracking from the new map ----
    before = counts()
    state = tracker.init_tracker_state(pose2, seed=2)
    prev = ffs[-1].sbi_track
    est = {0: se3.SE3(m.kf_R[0], m.kf_t[0]), N_TRAIL: pose2}
    quality, found = {}, []
    for i in range(N_TRAIL + 1, n_frames):
        out = tracker.track_frame_from_image(
            state, m, frames[i], prev, seq.cam, SIZE, cam_params,
            wiggle_scale=mm_cfg.wiggle_scale)
        state, prev = out.state, out.sbi_track
        est[i] = state.pose
        quality[i] = int(state.quality)
        found.append(int(out.result.found.sum()))
    track_counts = delta(before)
    idx = sorted(est)
    c_est = np.stack([(-(est[i].R.T @ est[i].t)).cpu().double().numpy()
                      for i in idx])
    c_gt = np.stack([(-(seq.pose(i).R.T @ seq.pose(i).t)).cpu().double()
                     .numpy() for i in idx])
    s_, R_, t_ = similarity_align(c_est, c_gt)
    path_err = np.linalg.norm(c_est @ (s_ * R_).T + t_ - c_gt, axis=1)
    R0, G0 = est[0].R, seq.pose(0).R

    def rot_err(i):
        rel = (est[i].R @ R0.T) @ (seq.pose(i).R @ G0.T).T
        return float(torch.linalg.vector_norm(se3.so3_log(rel)))

    r_errs = [rot_err(i) for i in idx]
    bad = [i for i, q in quality.items() if q != tracker.QUALITY_GOOD]
    print(f"[10] frames {N_TRAIL + 1}..{n_frames - 1} tracked from init's "
          f"pose: qualities not GOOD {bad}; found a frame min {min(found)} "
          f"max {max(found)}; rotation relative to frame 0 off the truth by "
          f"at most {max(r_errs):.2e} rad; camera path after a similarity "
          f"alignment (scale {s_:.4f}) off by at most {path_err.max():.2e}; "
          f"launches {track_counts}")
    check(not bad, f"frames not GOOD after init: {bad}")
    check(max(r_errs) < 0.01, f"rotation off the truth: {max(r_errs)}")
    check(path_err.max() < 0.02, f"camera path off the truth: "
          f"{path_err.max()}")
    want_track = {name: k["launches_per_frame"] * (n_frames - N_TRAIL - 1)
                  for name, k in kernels.items()}
    check(track_counts == want_track, "tracking launch counts after init "
          "differ")
    for name, n in counts().items():
        kernels[name]["launches"] += n
    # K6's eager calls in the init (compared after the count): the init's
    # own, then each epipolar level's (a captured level's warm-up; its
    # capture records nothing).
    k6_d = [a[3].shape[-1] for a in k6_calls]
    check(k6_d == [15] * 5, f"10: K6's eager calls in the init, by window "
          f"side: {k6_d}")
    if k6_d == [15] * 5:
        k6_against_plain(torch, k6_calls[:1], "10", "init", card)
        k6_against_plain(torch, k6_calls[1:], "10", "init's epipolar", card)

    # ---- card against CPU ----
    cff = [to_device(f, "cpu") for f in ffs]
    tdiffs, n_cmp = [], 0
    for i in range(1, N_TRAIL + 1):
        d = {}
        ctr, _ = initializer.trail_advance(to_device(trails[i - 1], "cpu"),
                                           cff[i - 1], cff[i], SIZE, diag=d)
        tdiffs += parity.trail_differences(trails[i], ctr, diags[i - 1], d,
                                           initializer.MINI_MAX_SSD)
        n_cmp += int(ctr.valid.sum())
    for d in tdiffs:
        print(f"[10] trail difference: {d}")
    check(all(d["reason"] for d in tdiffs), "unexplained trail difference")
    check(len(tdiffs) < 0.01 * n_cmp, "too many trail differences")

    c_trails = to_device(trails[-1], "cpu")
    matches = initializer.trails_to_matches(c_trails, cpu_cam,
                                            icfg.max_matches)
    cres = homography.compute(matches, u_mlesac, icfg.mlesac_sigma,
                              icfg.refine_iterations)
    Hg = hres.H.cpu() / torch.linalg.matrix_norm(hres.H.cpu())
    Hc = cres.H / torch.linalg.matrix_norm(cres.H)
    d_H = min(max_abs_diff(Hg, Hc), max_abs_diff(Hg, -Hc))
    print(f"[10] homography, card vs CPU: success {bool(hres.success)} / "
          f"{bool(cres.success)}, inliers {int(hres.n_inliers)} / "
          f"{int(cres.n_inliers)}, H/|H| {d_H:.2e} apart (up to sign)")
    check(bool(hres.success) == bool(cres.success)
          and int(hres.n_inliers) == int(cres.n_inliers) and d_H <= 1e-4,
          "card and CPU homographies differ")

    outs = {}
    n_threads = torch.get_num_threads()
    for name, threads in (("cpu", n_threads), ("cpu1", 1)):
        torch.set_num_threads(threads)
        cmk = new_maker("cpu", cpu_cam)
        t0 = time.perf_counter()
        cpose = initializer.init_from_stereo(cmk, cff[0], cff[-1], c_trails,
                                             u_mlesac, u_plane, icfg)
        outs[name] = (cpose is not None, init_outcome(torch, cmk),
                      time.perf_counter() - t0)
    torch.set_num_threads(n_threads)
    check(outs["cpu"][0] and outs["cpu1"][0], "stereo init failed on the CPU")
    g = init_outcome(torch, mk)
    d_card = init_diffs(torch, g, outs["cpu"][1])
    d_thr = init_diffs(torch, outs["cpu1"][1], outs["cpu"][1])
    print(f"[10] init, card vs CPU: {fmt_init(d_card)}; CPU 1 vs "
          f"{n_threads} threads: {fmt_init(d_thr)}; CPU init "
          f"{outs['cpu'][2]:.2f} s")
    check(d_card[0] <= 0.01 * n_pts, "card and CPU init differ in points")
    check(max(d_card[1], d_card[2]) <= INIT_POSE_TOL
          and d_card[3] <= INIT_PT_P99_TOL and d_card[4] <= INIT_WIGGLE_RTOL,
          "card and CPU init differ")

    # ---- relocalization ----
    sbi_size = ((H >> 3) // 2, (W >> 3) // 2)
    lost_ff = kflib.build_frame_tracking(frames[LOST_FRAME])
    lost = tracker.track_frame(
        tracker.init_tracker_state(se3.identity(dev), seed=3), m, lost_ff,
        prev_sbi=ffs[-1].sbi_track, cam=seq.cam, image_size=SIZE,
        cam_params=cam_params, wiggle_scale=mm_cfg.wiggle_scale)
    rr = relocalizer.attempt_recovery(m, lost_ff.sbi, cam_params, sbi_size)
    gt_c = -(seq.pose(LOST_FRAME).R.T @ seq.pose(LOST_FRAME).t)
    kf_frames = (0, N_TRAIL)
    nearest = int(np.argmin([float(torch.linalg.vector_norm(
        gt_c + seq.pose(f).R.T @ seq.pose(f).t)) for f in kf_frames]))
    rec_state = dataclasses.replace(
        tracker.init_tracker_state(rr.pose, seed=3),
        just_recovered=torch.ones((), dtype=torch.bool, device=dev))
    rec = tracker.track_frame(rec_state, m, lost_ff, ffs[-1].sbi_track,
                              seq.cam, SIZE, cam_params,
                              wiggle_scale=mm_cfg.wiggle_scale)
    c_rec = (-(rec.state.pose.R.T @ rec.state.pose.t)).cpu().double().numpy()
    rec_err = float(np.linalg.norm(s_ * R_ @ c_rec + t_
                                   - gt_c.cpu().double().numpy()))
    crr = relocalizer.attempt_recovery(
        to_device(m, "cpu"), to_device(lost_ff.sbi, "cpu"), cam_params.cpu(),
        sbi_size)
    d_rel = max(max_abs_diff(rr.pose.R.cpu(), crr.pose.R),
                max_abs_diff(rr.pose.t.cpu(), crr.pose.t))
    d_score = abs(float(rr.score) - float(crr.score)) / max(
        abs(float(crr.score)), 1.0)
    print(f"[10] relocalization of frame {LOST_FRAME}: tracked from the "
          f"identity its quality is {int(lost.state.quality)}; best keyframe "
          f"{int(rr.best_kf)} (nearest by the truth {nearest}), score "
          f"{float(rr.score):.1f}, success {bool(rr.success)}; tracked from "
          f"the recovered pose: quality {int(rec.state.quality)}, centre "
          f"{rec_err:.2e} off the aligned truth; card vs CPU: best keyframe "
          f"{int(crr.best_kf)}, success {bool(crr.success)}, score rel. "
          f"{d_score:.2e}, pose {d_rel:.2e}")
    check(int(lost.state.quality) != tracker.QUALITY_GOOD,
          "the frame tracked from the identity pose was not lost")
    check(int(rr.best_kf) == nearest and bool(rr.success),
          "relocalization did not recover")
    check(int(rec.state.quality) == tracker.QUALITY_GOOD and rec_err < 0.02,
          "the recovered frame did not track GOOD")
    check(int(crr.best_kf) == int(rr.best_kf)
          and bool(crr.success) == bool(rr.success) and d_rel <= 1e-4
          and d_score <= 1e-4, "card and CPU relocalization differ")

    # ---- times ----
    adv = lambda _: initializer.trail_advance(  # noqa: E731
        trails[-2], ffs[-2], ffs[-1], SIZE)
    u_dev = u_mlesac.to(dev)
    g_matches = initializer.trails_to_matches(trails[-1], seq.cam,
                                              icfg.max_matches)
    hom = lambda _: homography.compute(  # noqa: E731
        g_matches, u_dev, icfg.mlesac_sigma, icfg.refine_iterations)
    rel = lambda _: relocalizer.attempt_recovery(  # noqa: E731
        m, lost_ff.sbi, cam_params, sbi_size)
    rows = []
    for what, fn in (("trail_advance a frame", adv),
                     ("homography.compute", hom),
                     ("attempt_recovery", rel)):
        ev = time_ms(fn, torch, reps=10)
        host = host_ms(lambda: fn(None), torch, reps=10)
        dev_k, n_k = device_us(fn, torch, n=3)
        rows.append(f"{what} {ev:.3f} ms (CUDA events), {host:.3f} ms (host "
                    f"clock), device {fmt_us(dev_k)} in {n_k:.0f} kernels")
    print(f"[10] times: {'; '.join(rows)}; init_from_stereo {init_ms:.1f} "
          f"ms (host clock), {init_ev:.1f} ms (CUDA events) with "
          f"{stats['n_ba']} BA runs  [{card}]")
    for name, k in kernels.items():
        k["launches_per_trail_frame"] = per_trail[name]
        k["launches_per_init"] = want_init[name]



class HostDraws:
    """``engine.Draws`` on the CPU, moved to ``device``: engines on the
    card and on the CPU then draw the same numbers."""

    def __init__(self, engine, seed, device):
        self.base, self.device = engine.Draws(seed, "cpu"), device

    def rekey_tracker(self):
        self.base.rekey_tracker()

    def reset_mapmaker(self):
        self.base.reset_mapmaker()

    def track(self, n, out=None):
        drawn = self.base.track(n)
        if out is None:
            return tuple(u.to(self.device) for u in drawn)
        for buf, u in zip(out, drawn):
            buf.copy_(u)
        return out

    def mlesac(self, trials, n):
        return self.base.mlesac(trials, n).to(self.device)

    def plane(self, n_ransacs, n):
        return self.base.plane(n_ransacs, n).to(self.device)


class CallCounts:
    """Counts the calls of module functions while active (each patched
    with a counting wrapper, restored on exit): ``n`` by function, and
    ``mapping`` the calls made on the engine's mapping thread. A call
    made while a program is being captured runs nothing and is not
    counted; each replay of a program, and each run of an IF body,
    counts as the calls of the function its capture recorded
    (``graphs.replays``, ``graphs.replays_by_thread``; the bodies' runs
    are settled, a device sync, on entry and on exit)."""

    def __init__(self, targets):
        self.targets, self.n = targets, {name: 0 for _, name in targets}
        self.mapping = dict.fromkeys(self.n, 0)

    def __enter__(self):
        from ptam_cg_tpu_torch.models import graphs
        self.graphs = graphs
        graphs.settle_launches()
        self.replays = dict(graphs.replays)
        self.replays_mapping = dict(graphs.replays_by_thread.get("mapping",
                                                                 {}))
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                # No function runs on both threads at once: init runs the
                # mapping jobs on the tracking thread while no mapping
                # pass runs, so no count is lost.
                if not graphs.capturing():
                    if threading.current_thread().name == "mapping":
                        self.mapping[_name] += 1
                    self.n[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        graphs = self.graphs
        graphs.settle_launches()
        mapping = graphs.replays_by_thread.get("mapping", {})
        for name in self.n:
            self.n[name] += (graphs.replays.get(name, 0)
                             - self.replays.get(name, 0))
            self.mapping[name] += (mapping.get(name, 0)
                                   - self.replays_mapping.get(name, 0))


class CaptureLog:
    """Every program capture (``graphs.Program.capture``) while active, in
    ``caps``: label, thread, host-clock start and end of the whole call
    (warm-up and capture), and the Graph's ``warm_s`` and ``capture_s``."""

    def __enter__(self):
        from ptam_cg_tpu_torch.models import graphs
        self.graphs, self.caps = graphs, []
        self.capture = graphs.Program.capture
        capture, caps = self.capture, self.caps

        def logged(prog):
            if prog.graph is not None:
                return capture(prog)
            t0 = time.perf_counter()
            capture(prog)
            caps.append(dict(
                label=getattr(prog, "label", None) or type(prog).__name__,
                thread=threading.current_thread().name, t0=t0,
                t1=time.perf_counter(), warm_s=prog.graph.warm_s,
                capture_s=prog.graph.capture_s))
        graphs.Program.capture = logged
        return self

    def __exit__(self, *exc):
        self.graphs.Program.capture = self.capture


MAPMAKER_JOBS = ("integrations", "points integrated", "local BA",
                 "global BA", "new-point re-finds",
                 "re-finds of integrated points", "failure-queue re-finds",
                 "GC runs")


def watch_mapmaker(mm, jobs):
    """Count in ``jobs`` (keys ``MAPMAKER_JOBS``) the MapMaker's BA runs
    applied (local, global), integrations started, the points that landed
    integrations added, re-finds of new points started (and those among
    them started after an integration added points), re-finds of the
    failure queue started, and GC runs, by wrapping its methods."""
    poll = mm._ba_poll
    drain = mm._drain_integrate
    refind_new = mm.refind_newly_made
    grown = [False]

    def ba_poll(*a, **kw):
        job = mm._ba_job
        busy = poll(*a, **kw)
        if (job is not None and job["state"] is not None
                and mm._ba_job is None and not mm.reset_requested):
            jobs["local BA" if job["recent"] else "global BA"] += 1
        return busy

    def starts(name, key, ready):
        fn = getattr(mm, name)

        def wrapped(*a, **kw):
            jobs[key] += int(ready())
            return fn(*a, **kw)
        setattr(mm, name, wrapped)

    def drain_integrate(*a, **kw):
        pending = mm._pending_integrate
        slot = drain(*a, **kw)
        if slot is not None:
            n = pending.read()[1]
            jobs["points integrated"] += n
            grown[0] |= n > 0
        return slot

    def refind_newly_made(*a, **kw):
        if mm._new_points_pending and mm._refind_task is None:
            jobs["new-point re-finds"] += 1
            jobs["re-finds of integrated points"] += int(grown[0])
            grown[0] = False
        return refind_new(*a, **kw)

    mm._ba_poll = ba_poll
    mm._drain_integrate = drain_integrate
    mm.refind_newly_made = refind_newly_made
    starts("_integrate_start", "integrations", lambda: bool(mm.kf_queue))
    starts("refind_from_failure_queue", "failure-queue re-finds",
           lambda: mm._failures_pending and mm._refind_task is None)
    starts("handle_bad_points", "GC runs", lambda: mm._map_dirty)


def outcome_digest(infos):
    """A hash of every frame's outcome (stage, quality, found, points,
    keyframes, keyframe added, relocalized) and pose bytes: two runs with
    the same digest agree frame for frame, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for i in infos:
        h.update(repr((i.stage, i.quality, i.n_found, i.n_points, i.n_kfs,
                       i.added_kf, i.relocalized)).encode())
        h.update(i.pose.R.cpu().numpy().tobytes())
        h.update(i.pose.t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def engine_outcome(infos, seq, torch, tag):
    """11a's bars on a run's FrameInfos: init by frame 10, at least 80%
    of the tracked frames GOOD and more than 30 found after the first,
    keyframes added, ATE after Sim(3) alignment under 5% of the
    trajectory's span. Returns the first tracked frame."""
    from ptam_cg_tpu_torch.utils import evaluate
    from ptam_cg_tpu_torch.utils.se3 import SE3
    stages = [i.stage for i in infos]
    check("TRACKING" in stages and stages.index("TRACKING") <= 10,
          f"{tag}: no init by frame 10: {stages[:12]}")
    first = stages.index("TRACKING")
    check(stages[first:] == ["TRACKING"] * (len(stages) - first),
          f"{tag}: the map was lost after init")
    tracked = [(k, i) for k, i in enumerate(infos) if i.stage == "TRACKING"]
    good = sum(i.quality == 2 for _, i in tracked)
    bad_found = [(k, i.n_found) for k, i in tracked[1:] if i.n_found <= 30]
    est = evaluate.camera_centers(SE3(
        torch.stack([i.pose.R for _, i in tracked]),
        torch.stack([i.pose.t for _, i in tracked])))
    gt = torch.stack([-(seq.pose(k).R.T @ seq.pose(k).t) for k, _ in tracked])
    ate = evaluate.ate_rmse(est, gt)
    span = float(torch.linalg.vector_norm(gt.max(0).values - gt.min(0).values))
    n_added = sum(i.added_kf for i in infos)
    print(f"[11] {tag}: init on frame {first}; {good}/{len(tracked)} tracked "
          f"frames GOOD; found a tracked frame min "
          f"{min(i.n_found for _, i in tracked[1:])}; {n_added} keyframes "
          f"added, {infos[-1].n_kfs} in the map, {infos[-1].n_points} "
          f"points; relocalized on {sum(i.relocalized for i in infos)} "
          f"frames; ATE {ate:.3e} after Sim(3) alignment, trajectory span "
          f"{span:.4f} ({ate / max(span, 0.1) * 100:.3f}%); outcome digest "
          f"{outcome_digest(infos)}")
    check(good >= 0.8 * len(tracked), f"{tag}: under 80% of frames GOOD")
    check(not bad_found, f"{tag}: frames with 30 or fewer found: {bad_found}")
    check(n_added > 0, f"{tag}: no keyframe added")
    check(ate < 0.05 * max(span, 0.1), f"{tag}: ATE {ate} over the bar")
    return first


def scaled_poses(infos, first, torch):
    """Each frame's R and t over |t| on the init frame, on the CPU."""
    s = float(torch.linalg.vector_norm(infos[first].pose.t))
    return [(i.pose.R.cpu(), i.pose.t.cpu() / s) for i in infos]


def engine_diffs(a, b, first, torch):
    """(frames whose outcome differs, max |dR|, max |dt| over |t|) of two
    runs of the same frames."""
    outcome = [(k, x.stage, x.quality, x.n_kfs, x.added_kf)
               for k, x in enumerate(a)]
    other = [(k, x.stage, x.quality, x.n_kfs, x.added_kf)
             for k, x in enumerate(b)]
    bad = [(x, y) for x, y in zip(outcome, other) if x != y]
    pa, pb = scaled_poses(a, first, torch), scaled_poses(b, first, torch)
    d_R = max(max_abs_diff(x[0], y[0]) for x, y in zip(pa[first:],
                                                        pb[first:]))
    d_t = max(max_abs_diff(x[1], y[1]) for x, y in zip(pa[first:],
                                                        pb[first:]))
    return bad, d_R, d_t


def engine_parity(a, b, first, torch):
    """Phases 11b and 19c: card run ``a`` against CPU run ``b``. Returns
    (frames whose outcome differs, the tracked frames whose found count
    differs as (frame, card, CPU), max |dR|, max |dt| over |t|)."""
    bad, d_R, d_t = engine_diffs(a, b, first, torch)
    found = [(k, x.n_found, y.n_found) for k, (x, y) in enumerate(zip(a, b))
             if k >= first and x.n_found != y.n_found]
    return bad, found, d_R, d_t


def parity_bars(found):
    """11b's bars, or those of a run whose found counts differ."""
    return ((ENG_ROT_TOL_FOUND, ENG_T_TOL_FOUND) if found
            else (ENG_ROT_TOL, ENG_T_TOL))


def check_engine_parity(tag, parity_):
    """Phase 11b's and 19c's checks on ``engine_parity``'s result."""
    bad, found, d_R, d_t = parity_
    bar_R, bar_t = parity_bars(found)
    check(not bad, f"{tag}: card and CPU engines differ in outcome")
    check(all(abs(c - g) <= ENG_FOUND_RTOL * g for _, c, g in found),
          f"{tag}: card and CPU found counts differ by more than "
          f"{ENG_FOUND_RTOL:.0%}")
    check(d_R <= bar_R and d_t <= bar_t,
          f"{tag}: card and CPU engine poses differ")


def fmt_parity(parity_):
    _, found, d_R, d_t = parity_
    bar_R, bar_t = parity_bars(found)
    return (f"found counts that differ (frame, card, CPU) {found}; |dR| "
            f"{d_R:.2e}, |dt| / |t| {d_t:.2e} (bars {bar_R:.0e}, "
            f"{bar_t:.0e})")


def latency_stats(infos, times):
    """p50, p95 and max (ms) of the tracked frames' ``process_frame``
    return times, keyframe frames apart (``n`` of them), and the keyframe
    frames' (frame, ms)."""
    tracked = [(k, times[k]) for k, i in enumerate(infos[:len(times)])
               if i.stage == "TRACKING"]
    steady = sorted(t * 1e3 for k, t in tracked if not infos[k].added_kf)
    pct = lambda q: steady[min(len(steady) - 1, int(q * len(steady)))]  # noqa
    return dict(p50=pct(0.5), p95=pct(0.95), max=steady[-1], n=len(steady),
                kf_frames=[(k, round(t * 1e3, 1)) for k, t in tracked
                           if infos[k].added_kf])


def print_captures(phase, eng):
    """The CUDA graphs an engine's MapMaker captured during its run."""
    progs = eng.mapmaker._progs
    caps = [] if progs is None else progs.captures
    secs = [s for _, s in caps]
    print(f"[{phase}] the MapMaker's captures in the run: {len(caps)}, "
          f"{sum(secs):.2f} s in all, the longest "
          f"{max(secs, default=0.0):.3f} s: "
          f"{[(label, round(s, 3)) for label, s in caps]}")


def print_variants(phase, what, variants, card):
    """A phase's tracked-frame latency (p50, p95, max; keyframe frames
    apart: their count and median) and FPS, one line per variant."""
    for tag, v in variants.items():
        kf = [t for _, t in v["kf_frames"]]
        kf_med = f"{statistics.median(kf):.1f} ms" if kf else "none"
        on = (what if "frames" not in v
              else f"{what.split('frames')[0]}frames 0..{v['frames'] - 1}")
        print(f"[{phase}] {tag}, {on}: p50 {v['p50']:.1f} ms, p95 "
              f"{v['p95']:.1f} ms, max {v['max']:.1f} ms over {v['n']} "
              f"frames; {len(kf)} keyframe frames, median {kf_med}; "
              f"{v['fps']:.2f} FPS  [{card}]")


def engine_targets():
    """The functions that launch each kernel on the engine's path: K1 in
    every build, K3 in a keyframe build; K2 4 a tracked frame, 2 a
    re-find of one keyframe, 3 an epipolar level, 1 at the trail start, 3
    a trail frame, 2 in an init outside its epipolar levels; K4 2 a
    tracked frame; K5 1 a tracked frame and 1 a relocalization; K6 2 a
    tracked frame, 1 a re-find, 1 an epipolar level, 1 in an init outside
    its epipolar levels."""
    from ptam_cg_tpu_torch.models import initializer, keyframe, mapmaker
    from ptam_cg_tpu_torch.models import relocalizer, tracker
    return [(tracker, "track_frame_from_image"), (keyframe, "build_frame"),
            (mapmaker, "refind_in_kf"), (mapmaker, "add_points_epipolar"),
            (initializer, "trail_start"), (initializer, "trail_advance"),
            (initializer, "init_from_stereo"),
            (relocalizer, "attempt_recovery")]


def expected_launches(n):
    """The launches of each kernel that the calls ``n`` (by the names of
    ``engine_targets``) make."""
    return {"fast10": n["track_frame_from_image"] + n["build_frame"],
            "shi_tomasi": n["build_frame"],
            "gather_windows": 4 * n["track_frame_from_image"]
            + 2 * n["refind_in_kf"] + 3 * n["add_points_epipolar"]
            + n["trail_start"] + 3 * n["trail_advance"]
            + 2 * n["init_from_stereo"],
            "pose_gn": 2 * n["track_frame_from_image"],
            "sbi_esm": n["track_frame_from_image"] + n["attempt_recovery"],
            "subpix": 2 * n["track_frame_from_image"] + n["refind_in_kf"]
            + n["add_points_epipolar"] + n["init_from_stereo"]}


def compare_relocs(eng, torch):
    """Run each of ``eng``'s relocalizations also through an eager
    ``RelocProgram`` on the same inputs; the returned list gets, for each,
    (frame, equal in pose, best keyframe, score and success, success,
    the inputs: the five tables and the SBI, cloned)."""
    from ptam_cg_tpu_torch.models import programs
    found, run_prog = [], eng._run

    def comparing(prog, *args):
        out = run_prog(prog, *args)
        if isinstance(prog, programs.RelocProgram):
            m, sbi = args
            eager = programs.RelocProgram(
                eng.cfg, eng.image_size, cam_params=eng.cam_params,
                capacity=eng._capacity, device=eng.device, graphs=False)
            e = eager(m, sbi)
            same = (torch.equal(out.pose.R, e.pose.R)
                    and torch.equal(out.pose.t, e.pose.t)
                    and torch.equal(out.best_kf, e.best_kf)
                    and torch.equal(out.score, e.score)
                    and torch.equal(out.success, e.success))
            found.append((eng.frame_idx, same, bool(out.success), (
                programs.RelocView(*(getattr(m, f).clone()
                                     for f in programs.RelocView._fields)),
                type(sbi)(sbi.template.clone(), sbi.jac.clone()))))
        return out
    eng._run = comparing
    return found


def run(eng, ims, times=None, spans=None):
    """Each frame's FrameInfo; ``times`` gets each ``process_frame``'s
    return time on the host clock (no sync, as bench_engine.py), and
    ``spans`` its (start, end) on that clock."""
    infos = []
    for im in ims:
        t0 = time.perf_counter()
        infos.append(eng.process_frame(im))
        t1 = time.perf_counter()
        if times is not None:
            times.append(t1 - t0)
        if spans is not None:
            spans.append((t0, t1))
    return infos


def print_before(phase, variants, card):
    """One line: the default engine's p50, p95, max and FPS beside
    ``MapMaker(graphs=False)``'s in this run and beside ``BEFORE``."""
    def fmt(v):
        if v is None:
            return "not recorded"
        return ", ".join("-" if x is None else f"{x:.{1 if i < 3 else 2}f}"
                         for i, x in enumerate(v))
    now = {tag: (v["p50"], v["p95"], v["max"], v["fps"])
           for tag, v in variants.items()}
    was = BEFORE[phase]
    upto = ""
    if "fps_frames" in variants["default"]:
        upto = (f" (FPS to the last frame's result, the worker maybe still "
                f"capturing: default "
                f"{variants['default']['fps_frames']:.2f}, "
                f"MapMaker(graphs=False) "
                f"{variants['MapMaker eager']['fps_frames']:.2f})")
    print(f"[{phase}] p50, p95, max ms, FPS: default {fmt(now['default'])}; "
          f"MapMaker(graphs=False) {fmt(now['MapMaker eager'])}{upto}; as "
          f"PERF.md records them from before frames stopped waiting for "
          f"the worker's captures (run f2): default {fmt(was['default'])}, "
          f"MapMaker(graphs=False) {fmt(was['MapMaker eager'])}  [{card}]")


def engine(torch, dev, card, kernels, reset_counts, counts):
    """Phase 11: ``SLAMEngine.process_frame`` on bench_engine.py's scene,
    deterministic (11a), card against CPU (11b), the card's latency mode
    (11c), relocalization and reset (11d); then a faster orbit on which
    integrations add points, card against CPU (11e). Returns what phases
    12-13 reuse: both orbits' frames and sequences, the engine factory,
    ``run``, the launch-count targets and formula, and 11c's numbers."""
    import numpy as np
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import engine as englib

    W, H = SIZE
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                  **ENG_SEQ)
    frames = [seq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
              for i in range(ENG_SEQ["n_frames"])]

    def make(device, cand_min=ENG_CAND_MIN, capacity=ENG_MAP,
             map_graphs=True, **kw):
        """An engine; ``map_graphs=False`` runs its MapMakers' programs
        eagerly (``MapMaker(graphs=False)``) beside its own graphed ones."""
        cfg = EngineConfig(
            camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
            mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=cand_min))
        eng = englib.SLAMEngine(cfg, image_size=SIZE, device=device,
                                **capacity, **kw)
        if not map_graphs:
            new_map = eng._new_map

            def eager_maps():
                new_map()
                eng.mapmaker.graphs = False
            eng._new_map = eager_maps
            eng.mapmaker.graphs = False
        return eng

    targets, expected = engine_targets(), expected_launches

    # ---- 11a. the card, deterministic, every frame ----
    eng = make(dev, deterministic=True, draws=HostDraws(englib, 0, dev))
    jobs = dict.fromkeys(MAPMAKER_JOBS, 0)
    watch_mapmaker(eng.mapmaker, jobs)
    max_kfs_seen = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with CallCounts(targets) as calls:
        card_a = []
        for im in frames:
            card_a.append(eng.process_frame(im))
            max_kfs_seen.append(eng.mapmaker.n_kfs())
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    launches = counts()
    want = expected(calls.n)
    print(f"[11a] {W}x{H}, {len(frames)} frames, deterministic: {a_s:.1f} s "
          f"(host clock); calls {calls.n}; MapMaker jobs {jobs}; launches "
          f"{launches}, expected {want}  [{card}]")
    check(launches == want, "phase-11a launch counts differ")
    for name, n in launches.items():
        kernels[name]["launches"] += n
    first = engine_outcome(card_a, seq, torch, "11a")
    check(jobs["global BA"] > 0, "11a: no global BA was applied")
    check(jobs["local BA"] > 0 or max(max_kfs_seen) < 8,
          "11a: no local BA with 8 or more keyframes")
    check(jobs["failure-queue re-finds"] > 0 and jobs["GC runs"] > 0,
          "11a: the failure queue or GC never ran")

    # ---- 11b. card against CPU, the first frames through two keyframes
    # integrated by the scheduler ----
    n_b = next((k + 1 for k, i in enumerate(card_a) if i.n_kfs >= 4), None)
    check(n_b is not None, "11a: fewer than two keyframes integrated")
    cpu_runs = {}
    n_threads = torch.get_num_threads()
    for name, threads, n in (("cpu", n_threads, n_b), ("cpu1", 1, ENG_CPU1)):
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        cpu_runs[name] = run(make("cpu", deterministic=True,
                                  draws=HostDraws(englib, 0, "cpu")),
                             frames[:n])
        cpu_runs[name + " s"] = time.perf_counter() - t0
    torch.set_num_threads(n_threads)
    par = engine_parity(card_a[:n_b], cpu_runs["cpu"], first, torch)
    _, t_R, t_t = engine_diffs(cpu_runs["cpu1"], cpu_runs["cpu"][:ENG_CPU1],
                               first, torch)
    print(f"[11b] card vs CPU over frames 0..{n_b - 1} ({n_b - first} "
          f"tracked, {card_a[n_b - 1].n_kfs} keyframes): outcome differences "
          f"{par[0]}; {fmt_parity(par)}; CPU 1 vs "
          f"{n_threads} threads over frames 0..{ENG_CPU1 - 1}: |dR| "
          f"{t_R:.2e}, |dt| / |t| {t_t:.2e}; CPU {cpu_runs['cpu s']:.1f} s, "
          f"1 thread {cpu_runs['cpu1 s']:.1f} s")
    check_engine_parity("11b", par)

    # ---- 11c. the card's default (latency) mode ----
    eng = make(dev)
    check(not eng.mapmaker.deterministic, "11c: the card's engine is not in "
          "latency mode")
    mm, busy_passes = eng.mapmaker, [0, 0]
    step = mm.step

    def counted_step(*a, **kw):
        # A pass that finds the last mapping dispatch still running on
        # the card skips its dispatch (the backpressure of latency mode).
        busy_passes[0] += 1
        busy_passes[1] += int(mm._last_dispatch is not None
                              and not mm._last_dispatch.query())
        return step(*a, **kw)
    mm.step = counted_step
    n_main = len(frames) - ENG_PROFILE - ENG_SYNC
    times = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with CallCounts(targets) as calls:
        lat = run(eng, frames[:n_main], times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        passes, busy = busy_passes
        syncs = []
        for im in frames[n_main: n_main + ENG_SYNC]:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    lat.append(eng.process_frame(im))
                    torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append(sorted(f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                                for w in caught
                                if "called a synchronizing" in str(w.message)))
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            lat += run(eng, frames[n_main + ENG_SYNC:])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - tp
    launches = counts()
    want = expected(calls.n)
    check(launches == want, f"phase-11c launch counts {launches} differ "
          f"from {want}")
    for name, n in launches.items():
        kernels[name]["launches"] += n
    busy_us = sum(t for _, t, _ in device_rows(prof))
    c = latency_stats(lat, times)
    c.update(fps=n_main / wall, busy=busy_us / 1e6 / prof_wall * 100)
    print(f"[11c] latency mode, frames 0..{n_main - 1}: tracked-frame latency "
          f"(host clock, process_frame's return, no sync) p50 "
          f"{c['p50']:.1f} ms, p95 {c['p95']:.1f} ms, max "
          f"{c['max']:.1f} ms over {c['n']} frames; keyframe frames "
          f"(frame, ms) {c['kf_frames']}; {n_main / wall:.2f} FPS over all "
          f"{n_main} frames ({wall:.1f} s, one sync at the end); mapping "
          f"passes that found the card busy {busy} of {passes}  [{card}]")
    print(f"[11c] host reads a tracked frame (sync debug mode, which does "
          f"not report the info vector's read: a copy to pinned memory and "
          f"an event wait), frames {n_main}..{n_main + ENG_SYNC - 1}: "
          f"{[len(x) for x in syncs]}; where: {sorted(set(sum(syncs, [])))}")
    print(f"[11c] device busy share over frames {n_main + ENG_SYNC}.."
          f"{len(frames) - 1} (profiler): {busy_us / 1e3:.1f} ms of device "
          f"time in {prof_wall * 1e3:.1f} ms, "
          f"{busy_us / 1e6 / prof_wall * 100:.1f}% busy; launches {launches}"
          f"  [{card}]")
    engine_outcome(lat, seq, torch, "11c")
    print_captures("11c", eng)
    # The same frames with the MapMaker's programs run eagerly, and with
    # every program run eagerly, in this process.
    variants = {"graphed": c}
    for tag, kw in (("MapMaker eager", dict(map_graphs=False)),
                    ("all eager", dict(graphs=False))):
        eng_v, times_v = make(dev, **kw), []
        n_v = n_main if tag == "MapMaker eager" else ENG_ALL_EAGER
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat_v = run(eng_v, frames[:n_v], times_v)
        torch.cuda.synchronize()
        variants[tag] = latency_stats(lat_v, times_v)
        variants[tag].update(fps=n_v / (time.perf_counter() - t0),
                             frames=n_v)
        engine_outcome(lat_v, seq, torch, f"11c {tag}")
    print_variants("11c", f"frames 0..{n_main - 1}", variants, card)
    print_before("11c", {"default": c,
                         "MapMaker eager": variants["MapMaker eager"]}, card)

    # ---- 11d. relocalization and reset (tests/test_engine_reloc.py) ----
    rseq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                   **RELOC_SEQ)
    rframes = [rseq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
               for i in range(RELOC_SEQ["n_frames"])]
    eng = make(dev, cand_min=INIT_CAND_MIN, capacity=dict(
        INIT_MAP, auto_init_frames=6, seed=0), deterministic=True)
    relocs = compare_relocs(eng, torch)
    info = run(eng, rframes[:12])[-1]
    check(info.stage == "TRACKING" and info.quality == 2,
          f"11d: not GOOD after 12 frames: {info}")
    rng = np.random.default_rng(0)
    noise = run(eng, [rng.uniform(0, 255, (H, W)).astype(np.float32)
                      for _ in range(6)])
    relocalized = any(i.relocalized for i in noise)
    back = []
    for i in (6, 7, 8, 6, 7, 8, 7, 7):
        back.append(eng.process_frame(rframes[i]))
        relocalized |= back[-1].relocalized
        if back[-1].quality == 2:
            break
    print(f"[11d] six noise frames: qualities {[i.quality for i in noise]}; "
          f"then the sequence again: "
          f"{[(i.quality, i.relocalized) for i in back]}; found "
          f"{back[-1].n_found}")
    check(noise[-1].quality != 2, "11d: the noise frames did not lose "
          "tracking")
    check(relocalized and back[-1].quality == 2 and back[-1].n_found > 50,
          "11d: no relocalization back to GOOD within 8 frames")
    check(relocs, "11d: no relocalization ran")

    def reset_run(map_graphs):
        """Init, a poisoned map that BA ditches, and init again: the
        FrameInfos and host-clock latencies of every frame, the run's
        seconds, and the MapMakers before and after the reset."""
        eng = make(dev, cand_min=INIT_CAND_MIN, capacity=dict(
            INIT_MAP, auto_init_frames=6, seed=0), deterministic=True,
            map_graphs=map_graphs)
        times = []
        t0 = time.perf_counter()
        infos = run(eng, rframes[:10], times)
        check(infos[-1].stage == "TRACKING", "11d: no init on the reset run")
        m, old_mm = eng.map, eng.mapmaker
        eng.map = eng.mapmaker.map = dataclasses.replace(
            m, meas_pos=torch.where(m.meas_valid[..., None],
                                    torch.tensor(3e19, device=dev),
                                    m.meas_pos))
        eng.mapmaker.converged_recent = True
        eng.mapmaker.converged_full = False
        after = []
        for im in rframes[10:]:
            after += run(eng, [im], times)
            if after[-1].stage == "NOT_STARTED":
                break
        again = []
        for im in rframes + rframes:
            again += run(eng, [im], times)
            if again[-1].stage == "TRACKING":
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(eng=eng, infos=infos + after + again, after=after,
                    again=again, times=times, wall=wall, old=old_mm)

    runs = {tag: reset_run(tag == "default")
            for tag in ("default", "MapMaker eager")}
    r = runs["default"]
    eng, after, again = r["eng"], r["after"], r["again"]
    reset = after[-1]
    print(f"[11d] poisoned meas_pos: stages after it "
          f"{[i.stage for i in after]} ({reset.n_points} points, "
          f"{reset.n_kfs} keyframes); re-initialized after {len(again)} "
          f"frames: {again[-1].stage}, {again[-1].n_points} points")
    check(reset.stage == "NOT_STARTED" and reset.n_points == 0
          and reset.n_kfs == 0 and not eng.mapmaker.reset_requested,
          "11d: the poisoned map was not ditched")
    check(again[-1].stage == "TRACKING", "11d: no re-init after the reset")
    e = runs["MapMaker eager"]
    check([i.stage for i in e["after"] + e["again"]]
          == [i.stage for i in after + again],
          "11d: the eager MapMaker's reset run took other stages")
    # The chunk graphs outlive the reset: the new MapMaker captures none
    # of a key the old one captured.
    seen = {lb for lb, _ in r["old"].programs.captures
            if lb.startswith("lm_chunk")}
    caps = eng.mapmaker.programs.captures
    chunks = [lb for lb, _ in caps if lb.startswith("lm_chunk")]
    print(f"[11d] captures after the reset: {len(caps)} "
          f"({[lb for lb, _ in caps]}); chunk graphs {len(chunks)}, of "
          f"keys captured before it "
          f"{len([lb for lb in chunks if lb in seen])} (before it: "
          f"{sorted(seen)}); the engine keeps "
          f"{len(eng.chunk_programs.kept())} chunk programs  [{card}]")
    check(seen and not [lb for lb in chunks if lb in seen],
          "11d: a chunk graph of a key seen before the reset was captured "
          "again")
    variants = {}
    for tag, x in runs.items():
        variants[tag] = latency_stats(x["infos"], x["times"])
        variants[tag].update(fps=len(x["times"]) / x["wall"])
    print_variants("11d", f"the reset run ({len(r['times'])} frames)",
                   variants, card)
    print_before("11d", variants, card)

    # ---- 11e. the map grows while the camera tracks: card and CPU ----
    gseq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                   **GROW_SEQ)
    gframes = [gseq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
               for i in range(GROW_SEQ["n_frames"])]
    grown, gjobs, secs, gtimes, mtimes = {}, {}, {}, [], []
    for tag, where, threads in (("card", dev, n_threads),
                                ("card, MapMaker eager", dev, n_threads),
                                ("CPU", "cpu", n_threads),
                                ("CPU 1 thread", "cpu", 1)):
        torch.set_num_threads(threads)
        eng = make(where, cand_min=INIT_CAND_MIN, deterministic=True,
                   draws=HostDraws(englib, 0, where),
                   map_graphs="eager" not in tag)
        gjobs[tag] = dict.fromkeys(MAPMAKER_JOBS, 0)
        watch_mapmaker(eng.mapmaker, gjobs[tag])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with CallCounts(targets) as calls:
            grown[tag] = run(eng, gframes, {"card": gtimes,
                                            "card, MapMaker eager": mtimes}
                             .get(tag))
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        if tag == "card":
            launches, want = counts(), expected(calls.n)
            grown_map = eng.snapshot()
    torch.set_num_threads(n_threads)
    check(launches == want, f"phase-11e launch counts {launches} differ "
          f"from {want}")
    for name, n in launches.items():
        kernels[name]["launches"] += n
    card_g, cpu_g = grown["card"], grown["CPU"]
    moved = [(k, i.n_points) for k, i in enumerate(card_g)
             if k == 0 or i.n_points != card_g[k - 1].n_points]
    print(f"[11e] {W}x{H}, test_slam_e2e.py's orbit over "
          f"{GROW_SEQ['n_frames']} frames, deterministic: card "
          f"{secs['card']:.1f} s, CPU {secs['CPU']:.1f} s, 1 thread "
          f"{secs['CPU 1 thread']:.1f} s (host clock); MapMaker jobs "
          f"{gjobs}; (frame, points) where the card's count moved "
          f"{moved}; launches {launches}  [{card}]")
    first_g = engine_outcome(card_g, gseq, torch, "11e")
    check(gjobs["card"]["points integrated"] > 0, "11e: no integration "
          "added a point")
    check(gjobs["card"]["re-finds of integrated points"] > 0, "11e: no "
          "re-find of the points an integration added")
    bad, d_R, d_t = engine_diffs(card_g, cpu_g, first_g, torch)
    bad1, t_R, t_t = engine_diffs(grown["CPU 1 thread"], cpu_g, first_g,
                                  torch)

    def point_diffs(a, b):
        return [(k, x.n_points, y.n_points) for k, (x, y)
                in enumerate(zip(a, b)) if x.n_points != y.n_points]
    print(f"[11e] over frames 0..{len(gframes) - 1}, card vs CPU: outcome "
          f"differences {bad}; point counts that differ (frame, card, CPU) "
          f"{point_diffs(card_g, cpu_g)}; |dR| {d_R:.2e}, |dt| / |t| "
          f"{d_t:.2e}; CPU 1 vs {n_threads} threads: outcome differences "
          f"{bad1}; point counts that differ "
          f"{point_diffs(grown['CPU 1 thread'], cpu_g)}; |dR| {t_R:.2e}, "
          f"|dt| / |t| {t_t:.2e}")
    check(not bad, "11e: card and CPU engines differ in outcome")
    check(d_R <= GROW_ROT_TOL and d_t <= GROW_T_TOL,
          "11e: card and CPU engine poses differ")
    # The MapMaker's graphs against its eager programs, end to end.
    bad_m, m_R, m_t = engine_diffs(grown["card, MapMaker eager"], card_g,
                                   first_g, torch)
    print(f"[11e] card, the MapMaker's programs graphed vs eager: outcome "
          f"differences {bad_m}; point counts that differ "
          f"{point_diffs(grown['card, MapMaker eager'], card_g)}; |dR| "
          f"{m_R:.2e}, |dt| / |t| {m_t:.2e}; MapMaker jobs equal "
          f"{gjobs['card'] == gjobs['card, MapMaker eager']}")
    check(not bad_m and gjobs["card"] == gjobs["card, MapMaker eager"],
          "11e: the MapMaker's graphs and its eager programs differ in "
          "outcome")
    variants = {}
    for tag, times_v in (("graphed", gtimes),
                         ("MapMaker eager", mtimes)):
        key = "card" if tag == "graphed" else "card, MapMaker eager"
        variants[tag] = latency_stats(grown[key], times_v)
        variants[tag].update(fps=len(gframes) / secs[key])
    print_variants("11e", f"{len(gframes)} frames, deterministic",
                   variants, card)
    return dict(frames=frames, seq=seq, gframes=gframes, gseq=gseq,
                make=make, run=run, targets=targets, expected=expected,
                sync=c, grown=card_g, grown_times=gtimes, relocs=relocs,
                grown_map=grown_map, card_a=card_a)


def wait_for(cond, seconds=30.0):
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def async_outcome(infos, seq, torch, tag):
    """Phase 12's bars (tests/test_async_mapping.py's and the e2e's ATE):
    init succeeds, at least 80% of the tracked frames GOOD, at least 2
    keyframes in the map, the ATE after Sim(3) alignment under 5% of the
    trajectory's span. Returns the first tracked frame."""
    from ptam_cg_tpu_torch.utils import evaluate
    from ptam_cg_tpu_torch.utils.se3 import SE3
    tracked = [(k, i) for k, i in enumerate(infos) if i.stage == "TRACKING"]
    check(len(tracked) > 10, f"{tag}: init failed or too few tracked frames")
    good = sum(i.quality == 2 for _, i in tracked)
    est = evaluate.camera_centers(SE3(
        torch.stack([i.pose.R for _, i in tracked]),
        torch.stack([i.pose.t for _, i in tracked])))
    gt = torch.stack([-(seq.pose(k).R.T @ seq.pose(k).t) for k, _ in tracked])
    ate = evaluate.ate_rmse(est, gt)
    span = float(torch.linalg.vector_norm(gt.max(0).values - gt.min(0).values))
    print(f"[{tag}] init on frame {tracked[0][0]}; {good}/{len(tracked)} "
          f"tracked frames GOOD; {sum(i.added_kf for i in infos)} keyframes "
          f"added, {infos[-1].n_kfs} in the map, {infos[-1].n_points} points; "
          f"ATE {ate:.3e}, span {span:.4f} "
          f"({ate / max(span, 0.1) * 100:.3f}%)")
    check(good >= 0.8 * len(tracked), f"{tag}: under 80% of frames GOOD")
    check(infos[-1].n_kfs >= 2, f"{tag}: fewer than 2 keyframes")
    check(ate < 0.05 * max(span, 0.1), f"{tag}: ATE {ate} over the bar")
    return tracked[0][0]


def async_engine(torch, dev, card, kernels, reset_counts, counts, mods, ph11):
    """Phase 12: ``SLAMEngine(async_mapping=True)`` on phase 11's 240
    frames in latency mode, beside 11c's synchronous numbers; 12b: on
    11e's orbit, where integrations add points, then a reset while a
    mapping pass is in flight, and ``close()``. Its device syncs wait
    for a capture of the worker's to end (``graphs.synchronize``)."""
    from torch.profiler import ProfilerActivity, profile
    from ptam_cg_tpu_torch.models import graphs
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.models import mapmaker
    make, run, frames, seq = ph11["make"], ph11["run"], ph11["frames"], \
        ph11["seq"]
    W, H = SIZE

    # ---- 12. bench_engine.py's frames with the mapping worker ----
    eng = make(dev, async_mapping=True)
    check(not eng.mapmaker.deterministic, "12: not in latency mode")
    mm, passes = eng.mapmaker, [0, 0.0]
    step = mm.step

    def counted_step(*a, **kw):
        # The worker's passes and their seconds on the host clock.
        t = time.perf_counter()
        try:
            return step(*a, **kw)
        finally:
            passes[0] += 1
            passes[1] += time.perf_counter() - t
    mm.step = counted_step
    # No mapping pass runs while the profiler starts or stops (below): a
    # second thread launching kernels then can crash the profiler.
    gate, mapping_pass = threading.Lock(), eng._mapping_pass

    def gated_pass():
        with gate:
            return mapping_pass()
    eng._mapping_pass = gated_pass
    map_stream = eng._map_stream.cuda_stream
    n_main = len(frames) - ENG_PROFILE
    times = []
    graphs.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    spans = []
    with CallCounts(ph11["targets"] + [(ms, "copy_map")]) as calls:
        with CaptureLog() as caplog:
            infos = run(eng, frames[:n_main], times, spans)
        # The last frame's results are ready when the tracking stream
        # has run (a capture of the worker's may go on); then nothing
        # is under way on the card.
        torch.cuda.current_stream().synchronize()
        frames_s = time.perf_counter() - t0
        graphs.synchronize()
        wall = time.perf_counter() - t0
        prof = profile(activities=[ProfilerActivity.CUDA])
        with gate:
            graphs.synchronize()
            prof.start()
        tp = time.perf_counter()
        infos += run(eng, frames[n_main:])
        graphs.synchronize()
        prof_wall = time.perf_counter() - tp
        with gate:
            graphs.synchronize()
            prof.stop()
        check(wait_for(lambda: not eng.mapmaker.kf_queue), "12: the worker "
              "did not drain its keyframe queue")
        t1 = time.perf_counter()
        eng.close()
        close_s = time.perf_counter() - t1
        graphs.synchronize()
    launches = counts()
    by_stream = {name: dict(mod.launches_by_stream)
                 for name, mod in mods.items()}
    want = ph11["expected"](calls.n)
    m_calls = calls.mapping
    on_mapping = {"fast10": 0, "shi_tomasi": 0, "gather_windows":
                  2 * m_calls["refind_in_kf"]
                  + 3 * m_calls["add_points_epipolar"], "pose_gn": 0,
                  "sbi_esm": 0, "subpix": m_calls["refind_in_kf"]
                  + m_calls["add_points_epipolar"]}
    labels = {0: "legacy default (tracking)", map_stream: "mapping"}
    named = {name: {labels.get(k, str(k)): v for k, v in d.items()}
             for name, d in by_stream.items()}
    print(f"[12] launches {launches}, expected {want}; by stream {named}; "
          f"expected on the mapping stream {on_mapping}; mapping-thread "
          f"calls {m_calls}")
    check(launches == want, f"phase-12 launch counts {launches} differ "
          f"from {want}")
    check(on_mapping["gather_windows"] > 0, "12: the worker re-found or "
          "added no point (no K2 launch on the mapping stream)")
    for name, d in by_stream.items():
        check(set(d) <= {0, map_stream}, f"12: {name} launched on a stream "
              f"other than tracking's and mapping's: {d}")
        check(d.get(map_stream, 0) == on_mapping[name],
              f"12: {name}'s mapping-stream launches {d.get(map_stream, 0)} "
              f"!= the worker's calls' {on_mapping[name]}")
        check(d.get(0, 0) == launches[name] - on_mapping[name],
              f"12: {name}'s launches on the legacy default stream differ")
        kernels[name]["launches"] += launches[name]
        kernels[name]["launches_by_stream_async"] = named[name]
    busy_us = sum(t for _, t, _ in device_rows(prof))
    a = latency_stats(infos, times)
    a.update(fps=n_main / wall, fps_frames=n_main / frames_s,
             busy=busy_us / 1e6 / prof_wall * 100)
    m = eng.snapshot()
    nbytes = sum(t.numel() * t.element_size() for t in
                 (getattr(m, f.name) for f in dataclasses.fields(m)))
    copy_us, copy_kernels = device_us(lambda _: ms.copy_map(m), torch)
    copy_ms = time_ms(lambda _: ms.copy_map(m), torch)
    c = ph11["sync"]
    print(f"[12] async, frames 0..{n_main - 1}, latency mode: tracked-frame "
          f"latency (host clock, process_frame's return, no sync) p50 "
          f"{a['p50']:.1f} ms (11c sync {c['p50']:.1f}), p95 "
          f"{a['p95']:.1f} ms (11c {c['p95']:.1f}), max {a['max']:.1f} ms "
          f"(11c {c['max']:.1f}) over {a['n']} frames; keyframe frames "
          f"(frame, ms) {a['kf_frames']}; {a['fps']:.2f} FPS (11c "
          f"{c['fps']:.2f}; one sync at the end); mapping passes "
          f"{passes[0]} ({passes[1]:.1f} s in MapMaker.step on the host "
          f"clock), map copies {calls.n['copy_map']}; busy "
          f"{a['busy']:.1f}% of frames {n_main}..{len(frames) - 1} "
          f"({busy_us / 1e3:.1f} ms of device time in "
          f"{prof_wall * 1e3:.1f} ms; 11c {c['busy']:.1f}%); close() "
          f"{close_s:.2f} s  [{card}]")
    print(f"[12] map copy ({nbytes / 1e6:.2f} MB in "
          f"{len(dataclasses.fields(m))} tensors): device "
          f"{fmt_us(copy_us)} in {copy_kernels:.0f} kernels, CUDA events "
          f"{copy_ms:.4f} ms, bound (read + write at the HBM rate) "
          f"{2 * nbytes / HBM_BYTES_S * 1e6:.2f} us  [{card}]")
    async_outcome(infos, seq, torch, "12")
    print_captures("12", eng)
    check(close_s < 10.0, "12: close() did not join within 10 s")
    # No tracked frame waits for a capture of the worker's. The init
    # frame (stereo init and its BA, on this thread, before the worker
    # starts) is not a tracked frame, and a frame that captures a program
    # of its own (the first tracked frame its tracking program) lasts as
    # long as that capture: neither is held to it.
    first = [i.stage for i in infos].index("TRACKING")
    own = [(c["t0"], c["t1"]) for c in caplog.caps
           if c["thread"] != "mapping"]
    held = []
    for cap in caplog.caps:
        if cap["thread"] != "mapping":
            continue
        length = cap["t1"] - cap["t0"]
        over = [round((t1 - t0) * 1e3, 1) for k, (t0, t1) in enumerate(spans)
                if k > first and t0 < cap["t1"] and t1 > cap["t0"]
                and not any(t0 <= c0 and c1 <= t1 for c0, c1 in own)]
        print(f"[12] worker capture {cap['label']}: {length:.3f} s (warm-up "
              f"{cap['warm_s']:.3f} s, capture {cap['capture_s']:.3f} s); "
              f"the tracked frames it overlapped, ms: {over}  [{card}]")
        if length >= CAPTURE_HOLD_S and over and max(over) >= length * 1e3:
            held.append((cap["label"], round(length, 3), max(over)))
    check(not held, f"12: tracked frames as long as the worker capture they "
          f"overlapped (label, s, longest frame ms): {held}")
    # The same frames with the MapMaker's programs run eagerly, and with
    # every program run eagerly, in this process.
    variants = {"graphed": a}
    for tag, kw in (("MapMaker eager", dict(map_graphs=False)),
                    ("all eager", dict(graphs=False))):
        eng_v, times_v = make(dev, async_mapping=True, **kw), []
        n_v = n_main if tag == "MapMaker eager" else ENG_ALL_EAGER
        graphs.synchronize()
        t0 = time.perf_counter()
        infos_v = run(eng_v, frames[:n_v], times_v)
        torch.cuda.current_stream().synchronize()
        frames_s = time.perf_counter() - t0
        graphs.synchronize()
        variants[tag] = latency_stats(infos_v, times_v)
        variants[tag].update(fps=n_v / (time.perf_counter() - t0),
                             fps_frames=n_v / frames_s, frames=n_v)
        eng_v.close()
        async_outcome(infos_v, seq, torch, f"12 {tag}")
    print_variants("12", f"with the worker, frames 0..{n_main - 1}",
                   variants, card)
    print_before("12", {"default": a,
                        "MapMaker eager": variants["MapMaker eager"]}, card)
    print(f"[12] FPS to the last frame's result (the tracking stream "
          f"synced): " + ", ".join(f"{tag} {v['fps_frames']:.2f}"
                                   for tag, v in variants.items())
          + f"  [{card}]")

    # ---- 12b. 11e's orbit: integrations add points; a reset mid-pass ----
    gframes, gseq = ph11["gframes"], ph11["gseq"]
    eng = make(dev, cand_min=INIT_CAND_MIN, async_mapping=True)
    jobs = dict.fromkeys(MAPMAKER_JOBS, 0)
    watch_mapmaker(eng.mapmaker, jobs)
    infos = run(eng, gframes)
    check(wait_for(lambda: not eng.mapmaker.kf_queue), "12b: the worker did "
          "not drain its keyframe queue")
    first = async_outcome(infos, gseq, torch, "12b")
    n_init = infos[first].n_points

    def published():
        return int(eng.snapshot().point_valid.sum())
    # The worker may publish its integrations after the last frame (a
    # tracking program of a few ms a frame runs the orbit in under a
    # second): then the last frame again, until one frame's tracking map
    # holds the published points.
    grew = wait_for(lambda: published() > n_init)
    more = []
    while grew and len(more) < 8 and max(
            i.n_points for i in infos + more) <= n_init:
        more.append(eng.process_frame(gframes[-1]))
    n_seen = max(i.n_points for i in infos + more)
    print(f"[12b] {W}x{H}, {len(gframes)} frames: init map {n_init} points, "
          f"{published()} in the worker's last published map, at most "
          f"{n_seen} in the frames' results ({len(more)} repeats of the last "
          f"frame after the orbit); MapMaker jobs {jobs}")
    check(jobs["points integrated"] > 0 and grew,
          "12b: the worker's published map did not grow beyond the init map")
    check(n_seen > n_init, "12b: no tracked frame saw the grown map")
    mm = eng.mapmaker
    entered, release, left = (threading.Event() for _ in range(3))
    step = mm.step

    def blocked_step(*a, **kw):
        entered.set()
        release.wait(60.0)
        try:
            return step(*a, **kw)
        finally:
            left.set()
    mm.step = blocked_step
    eng.process_frame(gframes[-1])
    check(entered.wait(60.0), "12b: no mapping pass started")
    eng.process_frame(gframes[-2])          # a delta for the next pass
    eng.reset()
    pending = len(eng._pending_deltas)
    release.set()
    check(left.wait(60.0), "12b: the blocked pass did not end")
    time.sleep(0.5)
    m = eng.snapshot()
    empty = (int(m.point_valid.sum()), int(m.point_inlier.abs().sum()),
             int(m.point_outlier.abs().sum()), eng.mapmaker is not mm)
    again = []
    for im in gframes[:12]:
        again.append(eng.process_frame(im))
        if again[-1].stage == "TRACKING":
            break
    t1 = time.perf_counter()
    eng.close()
    close_s = time.perf_counter() - t1
    print(f"[12b] reset during a pass in flight: pending deltas after it "
          f"{pending}; map after the pass (points, |inliers|, |outliers|, a "
          f"new MapMaker) {empty}; (stage, points) until init "
          f"{[(i.stage, i.n_points) for i in again]}; close() "
          f"{close_s:.2f} s  [{card}]")
    check(pending == 0 and empty == (0, 0, 0, True),
          "12b: the reset left old map state or deltas")
    check(again[-1].stage == "TRACKING"
          and all(i.n_points == 0 and i.n_kfs == 0 for i in again[:-1]),
          "12b: the map was not empty until the next init")
    check(close_s < 10.0, "12b: close() did not join within 10 s")


def read_ppm(path):
    import numpy as np
    raw = open(path, "rb").read()
    _, w, h, _ = raw.split(maxsplit=4)[:4]
    w, h = int(w), int(h)
    return np.frombuffer(raw[len(raw) - w * h * 3:], np.uint8).reshape(
        h, w, 3)


def dataset_entry(torch, card, ph11):
    """Phase 13: ``apps.run_tum`` on a TUM-layout dataset of 11e's first
    frames through the native frame pump, with a settings file, a console
    script, a checkpoint, a map render and AR frames; then
    ``apps.run_synthetic`` with the mapping worker."""
    import os
    import tempfile

    import numpy as np
    from ptam_cg_tpu_torch import native
    from ptam_cg_tpu_torch.apps import run_synthetic, run_tum
    from ptam_cg_tpu_torch.io import checkpoint, tum
    gframes, gseq = ph11["gframes"], ph11["gseq"]
    n = DATASET_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        tum.write_synthetic_dataset(ds, gframes[:n],
                                    poses=[gseq.pose(i) for i in range(n)])
        with native.NativeFramePump(ds, loop=False) as pump:
            bad = [i for i in range(n) if not np.array_equal(
                pump.next_frame()[1],
                np.load(os.path.join(ds, "rgb", f"{i:06d}.npy")))]
        print(f"[13] native frame pump: {n} frames, differing from np.load "
              f"{bad}")
        check(not bad, "13: the native pump's frames differ from the files")
        cfg = os.path.join(tmp, "settings.cfg")
        with open(cfg, "w") as f:
            f.write(f"Camera.Parameters = [ {' '.join(map(str, REF_PARAMS))} "
                    f"]\nMapMaker.CandidateMinShiTomasiScore = "
                    f"{INIT_CAND_MIN}\n")
        mid, ck = os.path.join(tmp, "mid.npz"), os.path.join(tmp, "map.npz")
        cmds = os.path.join(tmp, "commands.txt")
        with open(cmds, "w") as f:
            f.write(f"@10 Bundle.MaxIterations=10\n@20 SaveMap {mid}\n"
                    f"@30 ShowInfo\n")
        ppm, ar_dir = os.path.join(tmp, "map.ppm"), os.path.join(tmp, "ar")
        t0 = time.perf_counter()
        out = run_tum.main([ds, "--native", "--settings", cfg, "--commands",
                            cmds, "--checkpoint", ck, "--map", ppm, "--ar",
                            ar_dir])
        secs = time.perf_counter() - t0
        eng = out["engine"]
        final = eng.snapshot()
        m, _ = checkpoint.load_map(ck)
        differ = [f.name for f in dataclasses.fields(m)
                  if not torch.equal(getattr(m, f.name),
                                     getattr(final, f.name))]
        ar_files = sorted(os.listdir(ar_dir))
        ar_std = [float(read_ppm(os.path.join(ar_dir, x)).std())
                  for x in ar_files]
        render = read_ppm(ppm)
        drawn = int((render != 25).any(-1).sum())
        tracked = [i for i in out["infos"] if i.stage == "TRACKING"]
        print(f"[13] run_tum on {len(out['infos'])} frames in {secs:.1f} s: "
              f"{len(tracked)} tracked, {sum(i.quality == 2 for i in tracked)} "
              f"GOOD; ATE {out['ate']:.3e}, span {out['span']:.4f}; console "
              f"{out['console']}; checkpoint fields differing from the final "
              f"map {differ}; AR frames {len(ar_files)} (pixel std "
              f"{[round(x, 1) for x in ar_std]}); map render {drawn} pixels "
              f"drawn  [{card}]")
        check(out["ate"] is not None
              and out["ate"] < 0.05 * max(out["span"], 0.1),
              "13: run_tum's ATE over the bar")
        check([f for f, _ in out["console"]] == [10, 20, 30]
              and eng.mapmaker.ba_cfg.max_iterations == 10
              and os.path.isfile(mid)
              and out["console"][2][1].startswith("stage=TRACKING"),
              "13: a console line did not run at its frame")
        check(not differ, "13: the checkpoint differs from the final map")
        check(ar_files and min(ar_std) > 10.0, "13: AR frames missing or "
              "blank")
        check(drawn > 100, "13: the map render is blank")
    t0 = time.perf_counter()
    syn = run_synthetic.main(["--async-mapping", "--frames", "40", "--size",
                              f"{SIZE[0]}x{SIZE[1]}"])
    print(f"[13] run_synthetic --async-mapping at {SIZE[0]}x{SIZE[1]}, 40 "
          f"frames: {time.perf_counter() - t0:.1f} s, ATE {syn['ate']:.3e}, "
          f"span {syn['span']:.4f}  [{card}]")
    check(syn["ate"] < 0.05 * max(syn["span"], 0.1),
          "13: run_synthetic's ATE over the bar")


# ---------------------------------------------------------------------------
# Phases 14-15: ranks of a torch.distributed group, each a process running
# this script with --rank (two on the one card over gloo)
# ---------------------------------------------------------------------------

def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(job, world, workdir, deadline_s=RANK_DEADLINE):
    """Run ``job`` on ``world`` gloo ranks, each this script with --rank
    on the card; returns each rank's results (``<job>_rank<r>.npz``
    written by the rank). Past the deadline every rank is killed and the
    phase fails; so does a rank that exits non-zero (its log's tail is
    printed)."""
    import os

    import numpy as np
    port = free_port()
    logs = [open(os.path.join(workdir, f"{job}_rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--job", job,
         "--dir", workdir], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.perf_counter() + deadline_s
    try:
        for proc in procs:
            proc.wait(timeout=max(end - time.perf_counter(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(workdir, f"{job}_rank{r}.log")) as f:
                print(f.read()[-4000:])
            fail(f"{job} rank {r} exited {proc.returncode} (killed at the "
                 f"{deadline_s} s deadline if negative)")
    return [dict(np.load(os.path.join(workdir, f"{job}_rank{r}.npz")))
            for r in range(world)]


class CollectiveStats:
    """Wraps a mesh's ``all_reduce`` and ``all_gather``: host seconds in
    them, and the floats each moves by (kind, size) and calls."""

    def __init__(self, mesh):
        self.mesh, self.seconds, self.calls = mesh, 0.0, {}
        for kind in ("all_reduce", "all_gather"):
            fn = getattr(mesh, kind)

            def wrapped(t, *a, _fn=fn, _kind=kind, **kw):
                t0 = time.perf_counter()
                out = _fn(t, *a, **kw)
                self.seconds += time.perf_counter() - t0
                key = (_kind, t.numel())
                self.calls[key] = self.calls.get(key, 0) + 1
                return out
            setattr(mesh, kind, wrapped)

    def reset(self):
        self.seconds, self.calls = 0.0, {}


class ChunkTimes:
    """While active, CUDA-event ms and host seconds of each call of
    ``module.name`` (an LM chunk)."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.ms, self.host = [], []

    def __enter__(self):
        torch, fn = self.torch, getattr(self.module, self.name)
        self.saved = fn

        def timed(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0 = time.perf_counter()
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            e1.synchronize()
            self.host.append(time.perf_counter() - t0)
            self.ms.append(e0.elapsed_time(e1))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def ba_outcome(torch, bundle, prob, cam, gt_pts):
    """(RMS px, median point error against the truth) of a final
    problem."""
    rms = float(bundle.residual_rms(prob, cam))
    err = torch.linalg.vector_norm(prob.pt_pos - gt_pts, dim=-1)
    return rms, float(err.median())


def rank_ba(torch, dev, rank, mesh, workdir, out):
    """Phase 14 on one rank: one sharded LM step (2 iterations at most),
    a whole ``compute_sharded`` timed by chunk with the collectives
    counted, and a run stopped after its first chunk with a checkpoint."""
    import os

    import numpy as np
    from ptam_cg_tpu_torch.config import BundleConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.parallel import sharded_ba
    prob, cam, _ = synth.ba_problem_large(device=dev, **SHARD_BA)
    stats = CollectiveStats(mesh)
    step_cfg = BundleConfig(max_iterations=2)
    shard, perm = sharded_ba.shard_problem(prob, mesh, return_perm=True)
    s, f = sharded_ba.sharded_lm_step_flags(
        sharded_ba.init_sharded_lm(shard, mesh, step_cfg), mesh, cam,
        step_cfg)
    back = sharded_ba.unshard_measurements(prob, s.problem, perm, mesh)
    for k in ("cam_R", "cam_t", "pt_pos", "meas_bad"):
        out[f"step.{k}"] = getattr(back, k).cpu().numpy()
    out["step.flags"] = np.array(f)
    out["step.error"] = np.array(float(s.last_error))
    stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ChunkTimes(torch, sharded_ba, "sharded_lm_chunk") as chunks:
        st, n, flags = sharded_ba.compute_sharded(prob, mesh, cam,
                                                  return_flags=True)
    torch.cuda.synchronize()
    out["run.seconds"] = np.array(time.perf_counter() - t0)
    for k in ("cam_R", "cam_t", "pt_pos", "meas_bad"):
        out[f"run.{k}"] = getattr(st.problem, k).cpu().numpy()
    out["run.flags"] = np.array([int(x) for x in flags] + [n])
    out["run.chunk_ms"] = np.array(chunks.ms)
    out["run.chunk_host"] = np.array(chunks.host)
    out["run.coll_seconds"] = np.array(stats.seconds)
    out["run.coll_calls"] = np.array([[k == "all_reduce", size, c] for
                                      (k, size), c in stats.calls.items()])
    # The same run with the step's stretches eager (``graphs=False``).
    with ChunkTimes(torch, sharded_ba, "sharded_lm_chunk") as eager:
        st, n, flags = sharded_ba.compute_sharded(prob, mesh, cam,
                                                  return_flags=True,
                                                  graphs=False)
    for k in ("cam_R", "cam_t", "pt_pos", "meas_bad"):
        out[f"eager.{k}"] = getattr(st.problem, k).cpu().numpy()
    out["eager.flags"] = np.array([int(x) for x in flags] + [n])
    out["eager.chunk_ms"] = np.array(eager.ms)
    # Chunks of one iteration each, graphed (the first chunk captures the
    # four stretches) and eager: ms an LM iteration.
    for key, on in (("g1", True), ("e1", False)):
        with ChunkTimes(torch, sharded_ba, "sharded_lm_chunk") as one:
            st, n, flags = sharded_ba.compute_sharded(
                prob, mesh, cam, return_flags=True, graphs=on,
                steps_per_dispatch=1)
        out[f"{key}.pt_pos"] = st.problem.pt_pos.cpu().numpy()
        out[f"{key}.flags"] = np.array([int(x) for x in flags] + [n])
        out[f"{key}.chunk_ms"] = np.array(one.ms)
    sharded_ba.compute_sharded(
        prob, mesh, cam, abort_check=lambda: True,
        checkpoint_path=os.path.join(workdir, "ckpt.npz"),
        checkpoint_every=1)


def rank_engine(torch, dev, rank, mesh, workdir, out):
    """Phase 15 on one rank: the deterministic engine with the mesh on
    11e's frames, with 11e's draws, launch counts and frame times."""
    import os

    import numpy as np
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    from ptam_cg_tpu_torch.kernels import fast as kfast
    from ptam_cg_tpu_torch.kernels import gather as kgather
    from ptam_cg_tpu_torch.kernels import pose_gn as kpose
    from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
    from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi
    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    from ptam_cg_tpu_torch.models import engine as englib
    from ptam_cg_tpu_torch.parallel import sharded_ba
    frames = np.load(os.path.join(workdir, "gframes.npy"))
    mods = {"fast10": kfast, "gather_windows": kgather, "shi_tomasi": kshi,
            "pose_gn": kpose, "sbi_esm": kesm, "subpix": ksubpix}
    shards = [0]
    orig = sharded_ba.shard_problem

    def counting(*a, **kw):
        shards[0] += 1
        return orig(*a, **kw)
    sharded_ba.shard_problem = counting
    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=INIT_CAND_MIN))
    eng = englib.SLAMEngine(cfg, image_size=SIZE, device=dev, **ENG_MAP,
                            deterministic=True,
                            draws=HostDraws(englib, 0, dev), mesh=mesh)
    jobs = dict.fromkeys(MAPMAKER_JOBS, 0)
    watch_mapmaker(eng.mapmaker, jobs)
    for mod in mods.values():
        mod.launches = 0
    times = []
    torch.cuda.synchronize()
    with CallCounts(engine_targets()) as calls:
        infos = run(eng, list(frames), times)
    torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in mods.items()}
    want = expected_launches(calls.n)
    out["outcome"] = np.array([
        [("NOT_STARTED", "TRAIL_TRACKING", "TRACKING").index(i.stage),
         i.quality, i.added_kf, i.relocalized, i.n_kfs, i.n_found,
         i.n_points] for i in infos])
    out["R"] = np.stack([i.pose.R.cpu().numpy() for i in infos])
    out["t"] = np.stack([i.pose.t.cpu().numpy() for i in infos])
    out["times"] = np.array(times)
    out["shards"] = np.array([shards[0], int(eng.mapmaker._use_sharded)])
    out["launches"] = np.array([[launches[k], want[k]] for k in KERNELS])
    out["jobs"] = np.array([jobs[k] for k in MAPMAKER_JOBS])


def rank_main(argv):
    """``--rank R --world W --port P --job ba|engine --dir D``: one rank of
    phase 14 or 15 on the card over gloo; writes ``D/<job>_rank<R>.npz``."""
    import argparse
    import os
    ap = argparse.ArgumentParser()
    for name in ("rank", "world", "port"):
        ap.add_argument(f"--{name}", type=int, required=True)
    ap.add_argument("--job", choices=["ba", "engine"], required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    dev = torch.device("cuda:0")
    meshlib.initialize_distributed(f"127.0.0.1:{args.port}", args.world,
                                   args.rank, backend="gloo",
                                   timeout_s=RANK_DEADLINE)
    mesh = meshlib.make_map_mesh(device=dev)
    check(mesh.size == args.world and mesh.backend == "gloo",
          "rank: the mesh is not the gloo world")
    out = {}
    {"ba": rank_ba, "engine": rank_engine}[args.job](
        torch, dev, args.rank, mesh, args.dir, out)
    mesh.barrier()
    np.savez(os.path.join(args.dir, f"{args.job}_rank{args.rank}.npz"),
             **out)
    torch.distributed.destroy_process_group()


def ranks_identical(ranks, keys, what):
    import numpy as np
    differ = [k for k in keys if not np.array_equal(ranks[0][k], ranks[1][k])]
    check(not differ, f"{what}: the ranks differ in {differ}")


def sharded_ba_phase(torch, dev, card):
    """Phase 14: point-sharded global BA at tests/test_sharded_ba.py::
    make_problem_large's full width (128 keyframes, 16,384 points, 65,536
    measurements): 2 ranks on the card over gloo, and NCCL with 1 rank,
    against the one-process ``bundle.compute`` on the card; ranks
    bit-identical; a checkpoint after the first chunk (2 ranks) resumed on
    1 rank; ms a chunk, floats a collective moves and the host time in
    collectives."""
    import os
    import tempfile

    import numpy as np
    from ptam_cg_tpu_torch.config import BundleConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import bundle
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    from ptam_cg_tpu_torch.parallel import sharded_ba
    prob, cam, (_, _, gt_pts) = synth.ba_problem_large(device=dev, **SHARD_BA)
    C, P, M = (prob.cam_R.shape[0], prob.pt_pos.shape[0],
               prob.meas_cam.shape[0])
    step_cfg = BundleConfig(max_iterations=2)
    s1 = bundle.lm_step(bundle.init_lm(prob, step_cfg), cam, step_cfg)
    f1 = bundle.flags(s1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ChunkTimes(torch, bundle, "lm_chunk") as one_chunks:
        one, n_one, one_flags = bundle.compute(prob, cam, return_flags=True)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_out = ba_outcome(torch, bundle, one.problem, cam, gt_pts)
    _, per2 = sharded_ba._shard_permutation(
        prob.meas_pt.cpu().numpy(), prob.meas_valid.cpu().numpy(),
        P // SHARD_RANKS, SHARD_RANKS)
    print(f"[14] problem: {C} cameras, {P} points, {M} measurements "
          f"({int(prob.meas_valid.sum())} valid), {SHARD_RANKS} ranks of "
          f"{P // SHARD_RANKS} points and {per2} measurement slots; "
          f"one-process compute: flags {one_flags} in {n_one} chunks, "
          f"{one_s:.2f} s, chunk ms {fmt_ms(one_chunks.ms)}, RMS "
          f"{one_out[0]:.3e} px, median point error {one_out[1]:.3e}  "
          f"[{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = launch_ranks("ba", SHARD_RANKS, tmp)
        ranks_s = time.perf_counter() - t0
        ranks_identical(ranks, [k for k in ranks[0]
                                if k.split(".")[0] in ("step", "run",
                                                       "eager", "g1", "e1")
                                and not k.endswith(".chunk_ms")
                                and not k.startswith(("run.chunk",
                                                      "run.seconds",
                                                      "run.coll"))],
                        "14")
        r0 = ranks[0]
        # 14e: the step's stretches replayed as CUDA graphs against the
        # same stretches run eagerly, on each rank.
        same = [all(np.array_equal(r[f"run.{k}"], r[f"eager.{k}"])
                    for k in ("cam_R", "cam_t", "pt_pos", "meas_bad",
                              "flags"))
                and all(np.array_equal(r[f"g1.{k}"], r[f"e1.{k}"])
                        for k in ("pt_pos", "flags")) for r in ranks]
        print(f"[14e] the sharded step's stretches as CUDA graphs vs eager "
              f"(2 gloo ranks): bit for bit on each rank {same}; chunk ms "
              f"(CUDA events, rank 0) of the default run graphed "
              f"{fmt_ms(r0['run.chunk_ms'])}, eager "
              f"{fmt_ms(r0['eager.chunk_ms'])}; chunks of one iteration "
              f"({int(r0['g1.flags'][4])} of them): graphed, the first with "
              f"its 4 captures {float(r0['g1.chunk_ms'][0]):.2f}, the rest "
              f"{fmt_ms(r0['g1.chunk_ms'][1:])}; eager "
              f"{fmt_ms(r0['e1.chunk_ms'])}; rank 1 graphed rest "
              f"{fmt_ms(ranks[1]['g1.chunk_ms'][1:])}, eager "
              f"{fmt_ms(ranks[1]['e1.chunk_ms'])}  [{card}]")
        check(all(same), "14e: the sharded replays differ from the eager "
              "stretches")
        # 14a: one step against the one-process step, at JAX's at-scale
        # bars (tests/test_sharded_ba.py).
        iters, acc = int(r0["step.flags"][1]), int(r0["step.flags"][3])
        e1, es = float(s1.last_error), float(r0["step.error"])
        dR = np.abs(r0["step.cam_R"] - s1.problem.cam_R.cpu().numpy()).max()
        dt = np.abs(r0["step.cam_t"] - s1.problem.cam_t.cpu().numpy()).max()
        dp = np.percentile(np.abs(r0["step.pt_pos"]
                                  - s1.problem.pt_pos.cpu().numpy()), 99)
        agree = float((r0["step.meas_bad"]
                       == s1.problem.meas_bad.cpu().numpy()).mean())
        print(f"[14a] one LM step (2 iterations at most), 2 gloo ranks vs one "
              f"process: iterations {iters} / {f1[1]}, accepted {acc} / "
              f"{f1[3]}, error {es:.6e} / {e1:.6e}, |dR| {dR:.2e}, |dt| "
              f"{dt:.2e}, points p99 {dp:.2e}, pruned flags agree "
              f"{agree:.5f}")
        check(iters == f1[1] and acc == f1[3], "14a: the sharded step "
              "differs from the one-process step in its flags")
        check(abs(es - e1) / max(e1, 1.0) < 1e-3 and dR < 2e-4
              and dt < 2e-4 and dp < 2e-3 and agree > 0.999,
              "14a: the sharded step differs from the one-process step")
        # 14b: the whole run, against the one-process run.
        run_prob = dataclasses.replace(
            prob, **{k: torch.from_numpy(r0[f"run.{k}"]).to(dev)
                     for k in ("cam_R", "cam_t", "pt_pos", "meas_bad")})
        sh_out = ba_outcome(torch, bundle, run_prob, cam, gt_pts)
        coll = {(bool(a), int(n)): int(c) for a, n, c in r0["run.coll_calls"]}
        tries = coll.get((True, 36 * C * C + 6 * C), 0)
        steps = coll.get((True, 42 * C + 1), 0)
        host = float(r0["run.chunk_host"].sum())
        print(f"[14b] compute_sharded on 2 gloo ranks (cuda:0): flags "
              f"{r0['run.flags'][:4].tolist()} in {r0['run.flags'][4]} "
              f"chunks, {float(r0['run.seconds']):.2f} s (2 processes "
              f"started and run in {ranks_s:.1f} s), chunk ms (CUDA events) "
              f"{fmt_ms(r0['run.chunk_ms'])}, RMS {sh_out[0]:.3e} px, median "
              f"point error {sh_out[1]:.3e}; {steps} steps and {tries} lambda "
              f"tries; floats all-reduced a try {36 * C * C + 6 * C} + 2 "
              f"({(36 * C * C + 6 * C + 2) * 4 / 1e6:.3f} MB), a step "
              f"{42 * C + 1} and an all_gather of {per2 * SHARD_RANKS} "
              f"squared errors (M = {M} padded per shard); calls (all_reduce,"
              f" floats): count {coll}; host time "
              f"in collectives {float(r0['run.coll_seconds']):.3f} s of "
              f"{host:.3f} s in chunks "
              f"({float(r0['run.coll_seconds']) / max(host, 1e-9) * 100:.1f}"
              f"%)  [{card}]")
        check(not r0["run.flags"][2] and not one_flags[2],
              "14b: a run failed")
        check(sh_out[0] < 0.05 and one_out[0] < 0.05
              and abs(sh_out[0] - one_out[0]) < 0.02,
              "14b: the sharded run's RMS is off the one-process run's")
        check(sh_out[1] < 5e-3 and one_out[1] < 5e-3,
              "14b: points not recovered")
        # 14c-d: NCCL with one rank; the 2-rank checkpoint resumed there.
        meshlib.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                       backend="nccl",
                                       timeout_s=RANK_DEADLINE)
        try:
            m1 = meshlib.make_map_mesh(device=dev)
            check(m1.backend == "nccl" and m1.size == 1,
                  "14c: not a one-rank NCCL mesh")
            m1.all_reduce(torch.zeros(1, device=dev))  # the communicator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ChunkTimes(torch, sharded_ba, "sharded_lm_chunk") as nc:
                st1, n1, fl1 = sharded_ba.compute_sharded(
                    prob, m1, cam, return_flags=True)
            torch.cuda.synchronize()
            n_s = time.perf_counter() - t0
            nccl_out = ba_outcome(torch, bundle, st1.problem, cam, gt_pts)
            ck = os.path.join(tmp, "ckpt.npz")
            from ptam_cg_tpu_torch.io.checkpoint import load_ba_state
            ck_iters = int(load_ba_state(ck, dev).iters)
            res, nr = sharded_ba.resume_sharded(ck, m1, cam)
            res_out = ba_outcome(torch, bundle, res.problem, cam, gt_pts)
        finally:
            torch.distributed.destroy_process_group()
    print(f"[14c] compute_sharded with NCCL, 1 rank: flags {fl1} in {n1} "
          f"chunks, {n_s:.2f} s, chunk ms {fmt_ms(nc.ms)}, RMS "
          f"{nccl_out[0]:.3e} px, median point error {nccl_out[1]:.3e}  "
          f"[{card}]")
    print(f"[14d] the 2-rank checkpoint after its first chunk (iteration "
          f"{ck_iters}) resumed on 1 NCCL rank: {nr} chunks, RMS "
          f"{res_out[0]:.3e} px (uninterrupted 2-rank run {sh_out[0]:.3e}), "
          f"median point error {res_out[1]:.3e}")
    check(not fl1[2] and nccl_out[0] < 0.05
          and abs(nccl_out[0] - one_out[0]) < 0.02 and nccl_out[1] < 5e-3,
          "14c: the NCCL run is off the one-process run")
    check(ck_iters >= 1 and nr >= 1 and res_out[0] < 0.05
          and abs(res_out[0] - sh_out[0]) < 0.02 and res_out[1] < 5e-3,
          "14d: the resumed run is off the uninterrupted run")


def fmt_ms(xs):
    xs = sorted(float(x) for x in xs)
    if not xs:
        return "[]"
    return (f"median {statistics.median(xs):.2f} (min {xs[0]:.2f}, max "
            f"{xs[-1]:.2f}, n {len(xs)})")


class RankInfo:
    """A FrameInfo rebuilt from a rank's arrays (stage, counts, pose)."""

    def __init__(self, torch, o, R, t):
        from ptam_cg_tpu_torch.utils.se3 import SE3
        self.stage = ("NOT_STARTED", "TRAIL_TRACKING", "TRACKING")[o[0]]
        (self.quality, self.added_kf, self.relocalized, self.n_kfs,
         self.n_found, self.n_points) = (int(o[1]), bool(o[2]), bool(o[3]),
                                         int(o[4]), int(o[5]), int(o[6]))
        self.pose = SE3(torch.from_numpy(R), torch.from_numpy(t))


def meshed_engine(torch, dev, card, kernels, ph11):
    """Phase 15: the engine with a 2-rank mesh (gloo, both ranks on the
    card) on 11e's orbit: the ranks agree frame by frame, global BA ran
    sharded, the outcome equals 11e's card run within phase 11's bars,
    the launches equal those the calls make; tracked-frame latency beside
    11e's."""
    import os
    import tempfile

    import numpy as np
    gseq, card_g, gtimes = ph11["gseq"], ph11["grown"], ph11["grown_times"]
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "gframes.npy"), np.stack(ph11["gframes"]))
        t0 = time.perf_counter()
        ranks = launch_ranks("engine", 2, tmp)
        secs = time.perf_counter() - t0
    ranks_identical(ranks, ["outcome", "R", "t", "shards", "launches",
                            "jobs"], "15")
    r0 = ranks[0]
    infos = [RankInfo(torch, o, R, t) for o, R, t in
             zip(r0["outcome"], r0["R"], r0["t"])]
    first = engine_outcome(infos, gseq, torch, "15")
    bad, d_R, d_t = engine_diffs(infos, card_g, first, torch)
    lat, lat11 = (latency_stats(infos, list(r0["times"])),
                  latency_stats(card_g, gtimes))
    launches = {k: int(v[0]) for k, v in zip(KERNELS, r0["launches"])}
    want = {k: int(v[1]) for k, v in zip(KERNELS, r0["launches"])}
    n_shards, use_sharded = (int(x) for x in r0["shards"])
    print(f"[15] 2-rank mesh (gloo, cuda:0) on 11e's {len(infos)} frames in "
          f"{secs:.1f} s (2 processes): shard_problem ran {n_shards} times; "
          f"MapMaker jobs {dict(zip(MAPMAKER_JOBS, r0['jobs'].tolist()))}; "
          f"launches {launches} (the calls make {want}); against 11e's card "
          f"run: outcome differences {bad}, |dR| {d_R:.2e}, |dt| / |t| "
          f"{d_t:.2e}; a tracked frame p50 {lat['p50']:.1f} ms, p95 "
          f"{lat['p95']:.1f} ms (11e in this run: p50 {lat11['p50']:.1f}, "
          f"p95 {lat11['p95']:.1f}; {lat['n']} / {lat11['n']} frames, "
          f"keyframes apart)  [{card}]")
    check(use_sharded == 1 and n_shards >= 1, "15: global BA did not run "
          "sharded")
    check(launches == want, "15: launch counts differ from the calls'")
    check(not bad, "15: the meshed engine differs from 11e in outcome")
    check(d_R <= GROW_ROT_TOL and d_t <= GROW_T_TOL,
          "15: the meshed engine's poses differ from 11e's")
    for name, n in launches.items():
        kernels[name]["launches"] += n
        kernels[name]["launches_mesh_rank0"] = n


PROGRAM_KERNELS = {"fast10": (r"\d+fast10_atlas_kernel",),
                   "gather_windows": (r"\d+gather_kernel",
                                      r"\d+gather_pair_kernel"),
                   "shi_tomasi": (r"\d+shi_tomasi_atlas_kernel",),
                   "pose_gn": (r"\d+pose_gn_kernel",),
                   "sbi_esm": (r"\d+sbi_esm_kernel",),
                   "subpix": (r"\d+subpix_kernel",)}
#: A tracked frame's launches and copies besides its graph replay.
OUTSIDE_LAUNCHES = 22
RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                    "cudaMemsetAsync", "cudaGraphLaunch")


def dot_nodes(path):
    """(nodes, {kernel: nodes launching it}) of a CUDA graph's DOT dump
    (``CUDAGraph.debug_dump``), by the kernels' mangled names."""
    import re
    text = open(path).read()
    # A node's line starts with its name and "["; an edge's with "->".
    starts = [mt.start() for mt in re.finditer(
        r'^\s*"graph_\d+_node_\d+"\s*\[', text, re.M)]
    blocks = [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]
    return len(blocks), {name: sum(any(re.search(p, b) for p in pats)
                                   for b in blocks)
                         for name, pats in PROGRAM_KERNELS.items()}


class PlainCalls:
    """Counts calls of the kernels' plain versions while active."""

    def __init__(self, mods):
        self.targets = [(mods["fast10"], "fast_atlas_plain"),
                        (mods["gather_windows"], "gather_windows_plain"),
                        (mods["gather_windows"], "gather_window_pair_plain"),
                        (mods["shi_tomasi"], "shi_tomasi_atlas_plain"),
                        (mods["pose_gn"], "pose_gn_plain"),
                        (mods["sbi_esm"], "esm_plain"),
                        (mods["subpix"], "subpix_refine_plain")]
        self.n = 0

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def wrapped(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def program_numbers(torch, card, mods, tag, graphed, eager, want):
    """Phase 17's numbers of one program, filled and called once each:
    capture s, graph nodes (and those of K1-K6, equal to the launches the
    capture recorded and to ``want``), a replay's ms by CUDA events and
    by the host clock, device us; the eager call's launches, ms and
    device us beside them."""
    g = graphed.graph
    nodes, by_kernel = dot_nodes(graphed.debug_path)
    tally = {name: g.launches.get(mod, 0) for name, mod in mods.items()}
    r_ms = time_ms(lambda _: graphed.run(), torch)
    r_host = host_ms(graphed.run, torch)
    r_us, r_n = device_us(lambda _: graphed.run(), torch, n=5)
    e_ms = time_ms(lambda _: eager.run(), torch, reps=5)
    e_host = host_ms(eager.run, torch, reps=5)
    e_us, e_n = device_us(lambda _: eager.run(), torch, n=3)
    print(f"[17] {tag}: capture {g.capture_s:.3f} s; {nodes} graph nodes "
          f"({by_kernel} of K1-K6; the capture recorded {tally}) against "
          f"{e_n:.0f} kernels an eager call; a replay {r_ms:.3f} ms (CUDA "
          f"events), {r_host:.3f} ms (host clock), device {fmt_us(r_us)} "
          f"in {r_n:.0f} kernels; eager {e_ms:.3f} ms (CUDA events), "
          f"{e_host:.3f} ms (host clock), device {fmt_us(e_us)}  [{card}]")
    check(tally == want and by_kernel == want,
          f"17: {tag}'s graph holds {by_kernel} K1-K6 nodes, its capture "
          f"recorded {tally}; want {want}")


def outside_launches(torch, ph11, dev):
    """The host's launches and copies of one steady tracked frame of a
    graphed engine (11c's frames), outside the mapping pass, by the op
    that made them (torch.profiler's runtime-API rows)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = ph11["make"](dev)
    frames = ph11["frames"]
    ph11["run"](eng, frames[:30])
    step = eng.mapmaker.step

    def marked(*a, **kw):
        with record_function("mapping pass"):
            return step(*a, **kw)
    eng.mapmaker.step = marked
    for k in range(30, 40):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            info = eng.process_frame(frames[k])
            torch.cuda.synchronize()
        if info.stage == "TRACKING" and not info.added_kf:
            break
    made = {}
    for e in prof.events():
        if e.name not in RUNTIME_LAUNCHES:
            continue
        chain, up = [], e.cpu_parent
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        if "mapping pass" in chain:
            continue
        by = f"{e.name} <- {chain[0] if chain else '?'}"
        made[by] = made.get(by, 0) + 1
    return k, made


def programs_phase(torch, dev, card, mods, seq, m, ff0, frames, im_kf,
                   ph11):
    """Phase 17: the engine's programs (``models/programs.py``) as CUDA
    graphs against the same programs run eagerly on the card: the
    tracking program on phase 4's map and frames (bit for bit, or within
    eager's own run-to-run spread), the keyframe build on phase 6's
    keyframe frame, the relocalizer on 11d's lost frames; each program's
    capture, nodes, replay and eager times; the host's launches of a
    tracked frame outside the replay, and the view copy's device time."""
    import os
    import tempfile
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.models import programs, tracker
    from ptam_cg_tpu_torch.utils import tree
    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=CAND_MIN))
    cam_params = torch.tensor(REF_PARAMS, device=dev)
    capacity = (m.point_pos.shape[0], m.kf_R.shape[0])
    tmpdir = tempfile.TemporaryDirectory()      # the graphs' dumps
    tmp = tmpdir.name

    def make(cls, graphs, dtype=torch.float32, cap=capacity):
        return cls(cfg, SIZE, seq.cam, cam_params, cap, dtype, device=dev,
                   graphs=graphs, debug_path=os.path.join(
                       tmp, f"{cls.__name__}.dot") if graphs else None)

    # ---- the tracking program on phase 4's frames ----
    gen = torch.Generator(device=dev).manual_seed(17)
    P = capacity[0]
    uniforms = [(torch.rand(P, generator=gen, device=dev),
                 torch.rand(P, generator=gen, device=dev)) for _ in frames]

    def track_run(prog):
        state = tracker.init_tracker_state(seq.pose(0), seed=0)
        prev, outs = ff0.sbi_track, []
        for im, (rc, rf) in zip(frames, uniforms):
            fo, inl, outl, info = prog(state, m, im, prev, rc, rf, 1.0)
            state, prev = fo.state, fo.sbi_track
            res = fo.result
            outs.append((state.pose.R.clone(), state.pose.t.clone(),
                         (res.meas_point * res.meas_valid
                          - (~res.meas_valid).long()).clone(),
                         info.clone(), inl.clone(), outl.clone()))
        return outs

    with PlainCalls(mods) as plain:
        graphed = make(programs.TrackProgram, True)
        g_outs = track_run(graphed)
    check(plain.n == 0, f"17: the tracking program called the kernels' "
          f"plain versions {plain.n} times")
    e_runs = [track_run(make(programs.TrackProgram, False))
              for _ in range(2)]

    def diffs(a, b):
        """(frames differing, max |dR|, max |dt|, found-set entries
        differing, info or counts differing)."""
        n_frames = d_R = d_t = n_found = n_info = 0
        for x, y in zip(a, b):
            same = all(torch.equal(u, v) for u, v in zip(x, y))
            n_frames += not same
            d_R = max(d_R, max_abs_diff(x[0], y[0]))
            d_t = max(d_t, max_abs_diff(x[1], y[1]))
            n_found += int((x[2] != y[2]).sum())
            n_info += not all(torch.equal(u, v) for u, v in
                              zip(x[3:], y[3:]))
        return n_frames, d_R, d_t, n_found, n_info
    spread = diffs(e_runs[0], e_runs[1])
    got = diffs(g_outs, e_runs[0])
    print(f"[17] tracking program on phase 4's {len(frames)} frames, replay "
          f"vs eager (frames differing, |dR|, |dt|, found-set entries, "
          f"info/count vectors): {got}; eager vs eager: {spread}")
    check(got == (0, 0.0, 0.0, 0, 0) or (
        got[1] <= spread[1] and got[2] <= spread[2]
        and got[3] <= spread[3] and got[4] <= spread[4]),
        "17: the tracking program's replays differ from the eager step "
        "beyond eager's own spread")
    program_numbers(torch, card, mods, "tracking program", graphed,
                    make(programs.TrackProgram, False),
                    {"fast10": 1, "gather_windows": 4, "shi_tomasi": 0,
                     "pose_gn": 2, "sbi_esm": 1, "subpix": 2})
    # The 14 view copies of a tracked frame, at the engine's capacity.
    eng_prog = make(programs.TrackProgram, False,
                    cap=(ENG_MAP["max_points"], ENG_MAP["max_kfs"]))
    src = tracker.make_track_view(ms.empty_map(
        SIZE, ENG_MAP["max_points"], ENG_MAP["max_kfs"], dev))
    nbytes = sum(t.numel() * t.element_size() for t in src)

    def copies(_):
        for buf, x in zip(eng_prog.view, src):
            buf.copy_(x)
    c_us, c_n = device_us(copies, torch)
    print(f"[17] the 14 TrackView copies at {ENG_MAP['max_points']} points "
          f"and {ENG_MAP['max_kfs']} keyframes ({nbytes / 1e6:.2f} MB): "
          f"device {fmt_us(c_us)} in {c_n:.0f} kernels, bound (read + "
          f"write at the HBM rate) {2 * nbytes / HBM_BYTES_S * 1e6:.2f} us"
          f"  [{card}]")

    # ---- the keyframe build on phase 6's keyframe frame ----
    with PlainCalls(mods) as plain:
        b_graph = make(programs.BuildProgram, True)
        fg = b_graph(im_kf)
    b_eager = make(programs.BuildProgram, False)
    fe = b_eager(im_kf)
    same = [f.name for f in dataclasses.fields(fg) if not all(
        torch.equal(a, b) for a, b in zip(tree.tensors(getattr(fg, f.name)),
                                          tree.tensors(getattr(fe, f.name))))]
    print(f"[17] keyframe build of phase 6's frame {N_TRACK_KF}: replay vs "
          f"eager, fields differing: {same}; plain-version calls in the "
          f"capture {plain.n}")
    check(not same and plain.n == 0, "17: the build program differs from "
          "the eager build")
    program_numbers(torch, card, mods, "keyframe build", b_graph, b_eager,
                    {"fast10": 1, "gather_windows": 0, "shi_tomasi": 1,
                     "pose_gn": 0, "sbi_esm": 0, "subpix": 0})

    # ---- the relocalizer on 11d's lost frames ----
    relocs = ph11["relocs"]
    print(f"[17] 11d's relocalizations, replay vs eager on the same inputs "
          f"(frame, equal, success): {[r[:3] for r in relocs]}")
    check(relocs and all(r[1] for r in relocs), "17: a relocalization's "
          "replay differs from the eager call")
    view, sbi = relocs[0][3]
    r_cap = (1, view.kf_R.shape[0])
    r_graph, r_eager = (make(programs.RelocProgram, g, None, r_cap)
                        for g in (True, False))
    r_graph(view, sbi)
    r_eager(view, sbi)
    program_numbers(torch, card, mods, "relocalizer", r_graph, r_eager,
                    {"fast10": 0, "gather_windows": 0, "shi_tomasi": 0,
                     "pose_gn": 0, "sbi_esm": 1, "subpix": 0})

    # ---- the host's launches of a tracked frame outside the replay ----
    k, made = outside_launches(torch, ph11, dev)
    n_graph = sum(v for key, v in made.items()
                  if key.startswith("cudaGraphLaunch"))
    n_other = sum(made.values()) - n_graph
    print(f"[17] frame {k} of 11c's engine (tracked, graphed): {n_graph} "
          f"graph launch and {n_other} other launches and copies outside "
          f"the mapping pass (want {OUTSIDE_LAUNCHES}: the 14 TrackView "
          f"copies, the frame's copy, the 2 uniform draws, the info read, "
          f"the map's 2 new counts and FrameInfo's 2 pose copies), by op: "
          f"{made}  [{card}]")
    check(n_graph == 1 and n_other == OUTSIDE_LAUNCHES,
          "17: a tracked frame's launches outside its graph differ")
    tmpdir.cleanup()


#: Phase 18's MapMaker programs of the keyframe integration, with the K2
#: launches each graph holds (2 in the re-find of the new keyframe, 3 an
#: epipolar level).
INTEGRATION_JOBS = (("insert", 2), ("epi_l3", 3), ("epi_l0", 3),
                    ("epi_l1", 3), ("epi_l2", 3))
#: Phase 18's LM chunks: (case, chunk limits; None for "iterations so far
#: + 1", JAX's step-flags program).
CHUNK_CASES = (("+1", [None] * 4), ("+5", [5, 10, 15, 20]), ("full", [20]))


def graph_nodes(path):
    """(nodes, conditional nodes) of a CUDA graph's DOT dump, the nodes of
    its conditional bodies included."""
    return dot_nodes(path)[0], open(path).read().count("CONDITIONAL")


class ProgramBuffers:
    """A MapMaker's program buffers as they are at construction, to put
    back before each timed call."""

    def __init__(self, p):
        self.p = p
        self.saved = [t.clone() for t in self.tensors()]

    def tensors(self):
        from ptam_cg_tpu_torch.utils import tree
        p = self.p
        return list(tree.tensors((p.map, p.failure, p.new_pts, p.refind,
                                  p.slot, p.tot, p.packed, p.k0, p.src,
                                  p.newest, p.adjust, p.fixed, p.pmask)))

    def restore(self):
        for buf, x in zip(self.tensors(), self.saved):
            buf.copy_(x)


def timed_numbers(torch, card, tag, graph, debug_path, replay, eager,
                  setup_g, setup_e, extra=""):
    """Phase 18's numbers of one program: capture s, graph nodes and IF
    nodes (from its dump), a replay's ms by CUDA events and by the host
    clock and its device us, and the eager call's beside them (each call
    after its ``setup``)."""
    nodes, n_cond = graph_nodes(debug_path)

    def host(fn, setup, reps):
        times = []
        for _ in range(reps):
            arg = setup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(arg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    r_ms = time_ms(replay, torch, reps=INT_REPS, setup=setup_g)
    r_host = host(replay, setup_g, INT_REPS)
    r_us, _ = device_us(replay, torch, n=1, setup=setup_g)
    e_ms = time_ms(eager, torch, reps=3, setup=setup_e)
    e_host = host(eager, setup_e, 3)
    e_us, e_n = device_us(eager, torch, n=1, setup=setup_e)
    print(f"[18] {tag}: capture {graph.capture_s:.3f} s; {nodes} graph "
          f"nodes ({n_cond} conditional: {graph.n_if} IF, {graph.n_while} "
          f"WHILE), against {e_n:.0f} kernels an eager call; a replay "
          f"{r_ms:.3f} ms (CUDA events), {r_host:.3f} ms (host clock), "
          f"device {fmt_us(r_us)}; eager {e_ms:.3f} ms (CUDA events), "
          f"{e_host:.3f} ms (host clock), device {fmt_us(e_us)}"
          f"{extra}  [{card}]")
    return dict(nodes=nodes, n_cond=n_cond, replay_ms=r_ms, eager_ms=e_ms)


def map_programs_phase(torch, dev, card, mods, kernels, ph6, ph11):
    """Phase 18: the MapMaker's programs (``MapPrograms``) and BA's LM
    chunk (``bundle.ChunkProgram``) as CUDA graphs against the same
    programs run eagerly on the card (``MapMaker(graphs=False)``): phase
    6's integration phase by phase, a span re-find on 11e's grown map,
    local BA's masks, extraction at the local and global tiers, BA and its
    write-back, GC and the plane alignment on phase 9's 64-keyframe map,
    all bit for bit; the LM chunk on phase 8's tiers (chunks of one step,
    five and all), a state at lambda's floor and a blown solve, in state
    and flags bit for bit, a step's retries inside the graph, and one host
    read a chunk. Each program's capture, nodes, conditional nodes,
    replay and eager times; the captures made and their memory pool."""
    import os
    import tempfile

    from ptam_cg_tpu_torch.config import BundleConfig, MapMakerConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import bundle, graphs, mapmaker
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.utils import mest
    from ptam_cg_tpu_torch.utils.tree import tensors as tree_tensors
    tmpdir = tempfile.TemporaryDirectory()
    makers = []

    def maker(m, cam, graphed, tag):
        path = os.path.join(tmpdir.name, tag) if graphed else None
        if path:
            os.makedirs(path, exist_ok=True)
        mm = mapmaker.MapMaker(ms.copy_map(m), cam, SIZE, deterministic=True,
                               graphs=graphed, graph_debug_dir=path)
        mm._n_points_hint = int(m.point_valid.sum())
        if graphed:
            makers.append((tag, mm))
        return mm

    def differ(a, b):
        """Fields of the two MapMakers' maps and masks that differ."""
        out = [f.name for f in dataclasses.fields(a.map)
               if not torch.equal(getattr(a.map, f.name),
                                  getattr(b.map, f.name))]
        for name in ("failure_mask", "new_point_mask"):
            if not torch.equal(getattr(a, name), getattr(b, name)):
                out.append(name)
        return out

    def k2():
        graphs.settle_launches()
        return mods["gather_windows"].launches

    # ---- phase 6's integration, phase by phase ----
    cam, res = ph6["cam"], ph6["res"]
    meas = dict(point=res.meas_point, pos=res.meas_pos,
                level=res.meas_level, subpix=res.meas_subpix,
                valid=res.meas_valid)
    g, e = (maker(ph6["m"], cam, x, "integration") for x in (True, False))
    bufs, per_phase = {}, []
    with PlainCalls(mods) as plain, CallCounts(
            [(mapmaker, "refind_in_kf"),
             (mapmaker, "add_points_epipolar")]) as cc:
        before = k2()
        for mm in (g, e):
            mm.add_keyframe(ph6["ff"], ph6["pose"], meas, res.depth_mean,
                            res.depth_sigma)
        graphed_k2 = 0
        for label, _ in INTEGRATION_JOBS:
            for mm, tag in ((g, "graphed"), (e, "eager")):
                k2_before = k2()
                if label == "insert":
                    mm._integrate_start()
                else:
                    # The state before the phase, for its timed calls.
                    bufs[label, tag] = ProgramBuffers(mm.programs)
                    mm._integrate_advance()
                if mm is g:
                    graphed_k2 += k2() - k2_before
            per_phase.append((label, differ(g, e)))
        slots = [mm._drain_integrate(block=True) for mm in (g, e)]
        packed = [mm.programs.packed.tolist() for mm in (g, e)]
    launched = k2() - before
    want = 2 * cc.n["refind_in_kf"] + 3 * cc.n["add_points_epipolar"]
    held = {label: (g.programs.jobs[label].graph.launches.get(
        mods["gather_windows"], 0), dot_nodes(
        g.programs.jobs[label].debug_path)[1]["gather_windows"])
        for label, _ in INTEGRATION_JOBS}
    print(f"[18] phase 6's integration, graphs vs eager programs: fields "
          f"differing after each phase {per_phase}; (slot, n_added) "
          f"{packed}; K2 launches of both {launched}, the calls' {want} "
          f"({cc.n}, warm-ups included); K2 in each graph (tally, dump) "
          f"{held}; plain-version calls in the captures {plain.n}")
    check(all(not d for _, d in per_phase) and packed[0] == packed[1]
          and slots[0] == slots[1], "18: the integration's graphs differ "
          "from its eager programs")
    check(plain.n == 0, "18: an integration capture called a plain version")
    check(launched == want and all(held[lb] == (n, n)
                                   for lb, n in INTEGRATION_JOBS),
          "18: the integration graphs' K2 launches differ from the calls'")
    kernels["gather_windows"]["launches"] += graphed_k2
    for label, _ in INTEGRATION_JOBS[1:]:
        gj, ej = g.programs.jobs[label], e.programs.jobs[label]
        gb, eb = bufs[label, "graphed"], bufs[label, "eager"]
        timed_numbers(torch, card, f"integration {label}", gj.graph,
                      gj.debug_path, lambda _, j=gj: j.graph.replay(),
                      lambda _, j=ej: j.run(), gb.restore, eb.restore)
    gj = g.programs.jobs["insert"]
    nodes, n_cond = graph_nodes(gj.debug_path)
    print(f"[18] integration insert: capture {gj.graph.capture_s:.3f} s; "
          f"{nodes} graph nodes, {n_cond} conditional (not timed: a replay "
          f"inserts into the next free slot)  [{card}]")

    # ---- a span re-find of a failure queue on 11e's grown map ----
    gm = ph11["grown_map"]
    K = gm.kf_valid.shape[0]
    probe = maker(gm, cam, False, "probe")
    probe.bundle_adjust_all()
    queue = probe.failure_mask.clone()
    # Every other keyframe also selects the points it does not measure, so
    # that some slots have work and some have none.
    valid = gm.kf_valid.nonzero()[:, 0].tolist()
    extra = torch.zeros_like(queue)
    for k in valid[::2]:
        extra[k] = gm.point_valid & ~gm.meas_valid[k]
    mask = queue | extra
    work = (gm.kf_valid & torch.any(
        mask & gm.point_valid & ~gm.meas_valid & ~gm.never_retry,
        dim=-1)).tolist()
    g, e = (maker(gm, cam, x, "refind") for x in (True, False))
    calls, pre = {}, {}
    for mm, tag in ((g, "graphed"), (e, "eager")):
        mm._load()
        mm._unload()
        pre[tag] = ProgramBuffers(mm.programs)
        for _ in range(2):
            # The first round captures; the second, from the same state,
            # is the one counted.
            pre[tag].restore()
            mm._start_refind_task(mask)
            before = k2()
            with CallCounts([(mapmaker, "refind_in_kf")]) as cc:
                while mm._refind_task is not None:
                    mm._refind_advance()
        calls[tag] = (cc.n["refind_in_kf"], k2() - before)
    d = differ(g, e)
    for mm, tag in ((g, "graphed"), (e, "eager")):
        # The buffers at the task's start, for the timed replays.
        pre[tag].restore()
        mm._start_refind_task(mask)
        mm.programs.k0.zero_()
        bufs[tag] = ProgramBuffers(mm.programs)
    n_work = sum(work)
    print(f"[18] span re-find on 11e's grown map ({len(valid)} keyframes in "
          f"{K} slots; BA's failure queue {int(queue.sum())} entries, every "
          f"other keyframe's unmeasured points besides): slots with work "
          f"{[k for k, w in enumerate(work) if w]}; (re-finds, K2 launches) "
          f"graphed {calls['graphed']}, eager {calls['eager']}; fields "
          f"differing {d}")
    check(not d, "18: the span re-find's graph differs from its eager "
          "program")
    check(calls["graphed"] == calls["eager"] == (n_work, 2 * n_work)
          and 0 < n_work < K, "18: the span re-find's re-finds or K2 "
          "launches differ from the calls'")
    label = f"refind_w{len(g._span_ks[0])}"
    gj, ej = g.programs.jobs[label], e.programs.jobs[label]
    timed_numbers(torch, card, f"span re-find ({label}, {n_work} of "
                  f"{len(g._span_ks[0])} slots with work)", gj.graph,
                  gj.debug_path, lambda _: gj.graph.replay(),
                  lambda _: ej.run(), bufs["graphed"].restore,
                  bufs["eager"].restore)

    # ---- BA's programs on phase 9's 64-keyframe map ----
    m64, cam64 = synth.ba_map(**BA_MAP, image_size=SIZE, device=dev)
    newest = BA_MAP["n_kfs"] - 1
    g, e = (maker(m64, cam64, x, "ba") for x in (True, False))
    steps = []
    tiers = {"local": BA_TIERS["local"], "global": BA_TIERS["global"]}
    u = torch.rand((MapMakerConfig().plane_aligner_ransacs,
                    m64.point_pos.shape[0]), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))

    def finish(mm):
        while mm._ba_job is not None:
            mm._ba_poll(block=True)

    for what, call in (
            ("local masks + extraction at the local tier", lambda mm: (
                setattr(mm, "_ba_caps", lambda: tiers["local"]),
                mm.bundle_adjust_recent(newest, start_only=True))),
            ("local BA's chunks and write-back", finish),
            ("global BA at the global tier", lambda mm: (
                setattr(mm, "_ba_caps", lambda: tiers["global"]),
                mm.bundle_adjust_all())),
            ("GC", lambda mm: (mm.mark_dirty(), mm.handle_bad_points())),
            ("plane alignment", lambda mm: mm.plane_align(u))):
        for mm in (g, e):
            call(mm)
        d = differ(g, e)
        if "extraction" in what:
            tg, te = g._ba_job["tier"], e._ba_job["tier"]
            d += [f for f, x, y in zip(
                ("problem", "mk", "mp", "cam_idx", "pt_idx", "counts"),
                (tg.prob, tg.mk, tg.mp, tg.cam_idx, tg.pt_idx, tg.counts),
                (te.prob, te.mk, te.mp, te.cam_idx, te.pt_idx, te.counts))
                if not all(torch.equal(a, b) for a, b in zip(
                    tree_tensors(x), tree_tensors(y)))]
        steps.append((what, d))
    print(f"[18] phase 9's map, graphs vs eager programs (fields that "
          f"differ): {steps}; reset requested {g.reset_requested}, "
          f"{e.reset_requested}")
    check(all(not d for _, d in steps) and not g.reset_requested,
          "18: BA's programs differ from their eager runs")
    p = g.programs
    for label in sorted(p.jobs):
        if label.startswith(("extract", "apply", "local", "gc", "plane")):
            nodes, n_cond = graph_nodes(p.jobs[label].debug_path)
            print(f"[18] {label}: capture "
                  f"{p.jobs[label].graph.capture_s:.3f} s, {nodes} graph "
                  f"nodes, {n_cond} conditional  [{card}]")
    for label in ("gc", "plane_align"):
        gj, ej = p.jobs[label], e.programs.jobs[label]
        gb, eb = ProgramBuffers(p), ProgramBuffers(e.programs)
        timed_numbers(torch, card, label, gj.graph, gj.debug_path,
                      lambda _, j=gj: j.graph.replay(),
                      lambda _, j=ej: j.run(), gb.restore, eb.restore)

    # ---- the LM chunk ----
    cfg, kind = BundleConfig(), mest.TUKEY
    problems = []
    for tier, (C, P, M) in BA_TIERS.items():
        prob, cam_b = synth.ba_problem(C, P, M, seed=0, fixed=(0, C // 2),
                                       device=dev)
        problems.append((tier, prob, cam_b, None))
    # A state at lambda's floor (the run's first ten tries, then lambda
    # 1e-10) and a blown solve (every inverse noise 1e18: the normal
    # equations overflow, the Cholesky fails, the state fails).
    prob, cam_b = synth.ba_problem(*BA_TIERS["local"], seed=0,
                                   fixed=(0, BA_TIERS["local"][0] // 2),
                                   device=dev)
    s10, _ = bundle.lm_chunk(bundle.init_lm(prob, cfg), cam_b, cfg, kind, 10,
                             bundle.INIT_FLAGS)
    problems.append(("local at lambda's floor", s10.problem, cam_b, 1e-10))
    problems.append(("local, blown solve", dataclasses.replace(
        prob, meas_sqrt_inv_noise=torch.where(
            prob.meas_valid, 1e18, prob.meas_sqrt_inv_noise)), cam_b, None))
    # The chunk programs share a pool, which must keep a graph alive:
    # they are all kept.
    pool, chunk_progs = torch.cuda.graph_pool_handle(), []
    retried, failed_seen, results = 0, False, []
    steps_n = [0]
    parts = bundle._step_parts

    def counted(*a, **kw):
        steps_n[0] += 1
        return parts(*a, **kw)
    for tier, prob, cam_b, lam in problems:
        start = bundle.init_lm(prob, cfg)
        if lam is not None:
            start = dataclasses.replace(start, lam=torch.full_like(start.lam,
                                                                   lam))
        prog = bundle.ChunkProgram(start, cam_b, cfg, kind, True,
                                   os.path.join(tmpdir.name,
                                                f"chunk_{len(results)}.dot"),
                                   pool)
        chunk_progs.append(prog)
        for case, limits in CHUNK_CASES:
            if "floor" in tier or "blown" in tier:
                if case != "full":
                    continue
            gs, fg = start, bundle.INIT_FLAGS
            es, fe = start, bundle.INIT_FLAGS
            same, tries, steps_case = True, 0, 0
            for lim in limits:
                limit = fe[1] + 1 if lim is None else lim
                if fe[0] or fe[2] or fe[1] >= limit:
                    break
                i0 = fe[1]
                steps_n[0] = 0
                bundle._step_parts = counted
                try:
                    es, fe = bundle.lm_chunk(es, cam_b, cfg, kind, limit, fe)
                finally:
                    bundle._step_parts = parts
                gs, fg = prog(gs, limit, fg)
                same &= fg == fe and all(
                    torch.equal(a, b) for a, b in zip(
                        bundle._state_tensors(gs), bundle._state_tensors(es)))
                tries += fe[1] - i0
                steps_case += steps_n[0]
            retried += tries > steps_case
            failed_seen |= bool(fe[2])
            results.append((tier, case, fe, tries, steps_case, same))
    print(f"[18] LM chunk graph vs eager lm_chunk (tier, chunks, final "
          f"flags, tries, steps, state and flags bit for bit): {results}")
    check(all(r[-1] for r in results), "18: an LM chunk graph differs from "
          "the eager chunk")
    check(retried > 0, "18: no step retried inside a chunk graph")
    check(failed_seen, "18: the blown solve did not set failed")
    # Host reads in a chunk, and the numbers of the local and global tiers.
    for tier, prob, cam_b, _ in problems[:2]:
        start = bundle.init_lm(prob, cfg)
        prog = bundle.ChunkProgram(start, cam_b, cfg, kind, True,
                                   os.path.join(tmpdir.name,
                                                f"chunk_{tier}.dot"), pool)
        chunk_progs.append(prog)
        prog(start, 5, bundle.INIT_FLAGS)
        saved = [t.clone() for t in bundle._state_tensors(start)]

        def restore(prog=prog, saved=saved):
            for buf, x in zip(bundle._state_tensors(prog.state), saved):
                buf.copy_(x)
        restore()
        g_reads = sync_count(lambda: prog(prog.state, 5, bundle.INIT_FLAGS),
                             torch)
        e_reads = sync_count(lambda: bundle.lm_chunk(
            start, cam_b, cfg, kind, 5, bundle.INIT_FLAGS), torch)
        _, f5 = bundle.lm_chunk(start, cam_b, cfg, kind, 5,
                                bundle.INIT_FLAGS)
        print(f"[18] BA {tier}: host reads in a 5-iteration chunk (sync "
              f"debug mode): graphed {g_reads}, eager {e_reads} "
              f"({f5[1]} tries)")
        check(g_reads == 1 and e_reads == f5[1],
              f"18: BA {tier}: host reads a chunk {g_reads} graphed, "
              f"{e_reads} eager")
        timed_numbers(torch, card, f"LM chunk, {tier} tier, 5 iterations",
                      prog.graph, prog.debug_path,
                      lambda _, prog=prog: prog(prog.state, 5,
                                                bundle.INIT_FLAGS),
                      lambda s, cam_b=cam_b: bundle.lm_chunk(
                          s, cam_b, cfg, kind, 5, bundle.INIT_FLAGS),
                      restore, lambda start=start: start,
                      extra=f"; pool {graphs.pool_bytes(pool) / 2**20:.1f} "
                            f"MiB (all chunk graphs so far)")
    # Two captures at once, each on a thread and a stream of its own (as
    # the engine's tracking thread and its worker may capture): each
    # graph's chunk equal to the eager chunk bit for bit.
    pair, errors, both = [], [], threading.Barrier(2)

    def capture_beside(tier, prob, cam_b):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                start = bundle.init_lm(prob, cfg)
                prog = bundle.ChunkProgram(start, cam_b, cfg, kind, True,
                                           pool=torch.cuda.graph_pool_handle())
                both.wait(60.0)
                t0 = time.perf_counter()
                prog.capture()
                t1 = time.perf_counter()
                gs, fg = prog(start, 5, bundle.INIT_FLAGS)
                es, fe = bundle.lm_chunk(start, cam_b, cfg, kind, 5,
                                         bundle.INIT_FLAGS)
                same = fg == fe and all(torch.equal(a, b) for a, b in zip(
                    bundle._state_tensors(gs), bundle._state_tensors(es)))
                pair.append((tier, t0, t1, prog.graph.capture_s, same))
        except Exception as e:      # reported and checked below
            errors.append((tier, repr(e)))
            both.abort()
    threads = [threading.Thread(target=capture_beside, args=x[:3],
                                name=f"capture {x[0]}")
               for x in problems[:2]]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300.0)
    overlap = (min(x[2] for x in pair) - max(x[1] for x in pair)
               if len(pair) == 2 else 0.0)
    print(f"[18] two LM chunk graphs captured at once on two threads "
          f"(tier, capture s, replay = eager bit for bit): "
          f"{[(x[0], round(x[3], 3), x[4]) for x in pair]}; the two calls "
          f"overlapped {overlap:.3f} s; errors {errors}  [{card}]")
    check(not errors and len(pair) == 2 and all(x[4] for x in pair)
          and overlap > 0, "18: two captures at once failed or differ")
    # The captures made and their pools.
    for tag, mm in makers:
        p = mm.programs
        caps = [(lb, round(s, 3)) for lb, s in p.captures]
        print(f"[18] MapMaker {tag}: {len(caps)} captures {caps}; pool "
              f"{graphs.pool_bytes(p.pool) / 2**20:.1f} MiB  [{card}]")
    tmpdir.cleanup()


def calibration_and_scene(torch, dev, card):
    """Phase 16: ``apps.run_calib --synthetic 5`` at 640x480 on the card
    (RMS, the parameters against the truth, the card against the CPU
    port); ``apps.make_synth_tum --nonplanar`` then ``apps.run_tum
    --native`` on it (ATE under test_slam_nonplanar.py's bar)."""
    import os
    import tempfile

    import numpy as np
    from ptam_cg_tpu_torch.apps import make_synth_tum, run_calib, run_tum
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.camera import calibrator
    W, H = SIZE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_calib.main(["--synthetic", "5", "--size", f"{W}x{H}"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, gt = out["params"], np.array(run_calib.GT_PARAMS)
    calib = out["calibrator"]
    # The CPU port: view 0's grid from the card's image, and the joint
    # optimization from the card's grids.
    v0 = calib.views[0]
    t0 = time.perf_counter()
    cpu_v = calibrator.CalibImage(v0.im.cpu(), device="cpu")
    cpu_ok = cpu_v.make_grid()
    grid_s = time.perf_counter() - t0
    same_grid = cpu_ok and [g.grid_pos for g in cpu_v.grid] == [
        g.grid_pos for g in v0.grid]
    d_grid = max((float(np.abs(a.params.pos - b.params.pos).max())
                  for a, b in zip(cpu_v.grid, v0.grid)), default=np.inf)
    cc = calibrator.CameraCalibrator((W, H), device="cpu")
    cam0 = atan.make_camera(tuple(cc.params), (W, H), "cpu")
    for v in calib.views:
        cv = object.__new__(calibrator.CalibImage)
        cv.im, cv.grid = v.im.cpu(), v.grid
        cv.guess_initial_pose(cam0)
        cc.views.append(cv)
    t0 = time.perf_counter()
    cpu_rms = cc.optimize(100)
    opt_s = time.perf_counter() - t0
    d_par = float(np.abs(np.abs(cc.params) - np.abs(got)).max())
    print(f"[16a] run_calib --synthetic 5 at {W}x{H} on the card: "
          f"{secs:.1f} s, views {out['views']} grid corners, RMS "
          f"{out['rms']:.4f} px, params {np.round(got, 6).tolist()} (truth "
          f"{gt.tolist()}); the CPU port: view 0's grid from the card's "
          f"image {'equal' if same_grid else 'DIFFERENT'} ({len(cpu_v.grid)} "
          f"corners, largest position difference {d_grid:.2e} px, "
          f"{grid_s:.1f} s), 100 steps from the card's grids RMS "
          f"{cpu_rms:.4f} px, params within {d_par:.2e} of the card's "
          f"({opt_s:.1f} s)  [{card}]")
    check(out["rms"] < 0.3, "16a: calibration RMS over 0.3 px")
    check(np.all(np.abs(got[:4] - gt[:4]) <= 0.02 * gt[:4])
          and abs(abs(got[4]) - gt[4]) < 0.01,
          "16a: the parameters are off test_calibrator.py's bars")
    check(same_grid and d_grid < CALIB_GRID_TOL,
          "16a: the CPU port grows another grid")
    check(d_par < CALIB_PARAM_TOL and abs(cpu_rms - out["rms"]) < 1e-4,
          "16a: the CPU port's calibration differs from the card's")
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        t0 = time.perf_counter()
        make_synth_tum.main([ds, "--nonplanar", "--frames",
                             str(NONPLANAR_FRAMES), "--size", f"{W}x{H}"])
        make_s = time.perf_counter() - t0
        cfg = os.path.join(tmp, "settings.cfg")
        with open(cfg, "w") as f:
            f.write(f"Camera.Parameters = [ {' '.join(map(str, REF_PARAMS))} "
                    f"]\nMapMaker.CandidateMinShiTomasiScore = "
                    f"{INIT_CAND_MIN}\n")
        t0 = time.perf_counter()
        res = run_tum.main([ds, "--native", "--settings", cfg])
        tum_s = time.perf_counter() - t0
    tracked = [i for i in res["infos"] if i.stage == "TRACKING"]
    good = sum(i.quality == 2 for i in tracked)
    print(f"[16b] make_synth_tum --nonplanar: {NONPLANAR_FRAMES} frames at "
          f"{W}x{H} in {make_s:.1f} s; run_tum --native: {tum_s:.1f} s, "
          f"{len(tracked)} tracked, {good} GOOD, {res['infos'][-1].n_points} "
          f"points, {res['infos'][-1].n_kfs} keyframes; ATE "
          f"{res['ate']:.3e}, span {res['span']:.4f} "
          f"({res['ate'] / max(res['span'], 0.1) * 100:.3f}%, bar 8%)  "
          f"[{card}]")
    check(len(tracked) > 12 and good > 0.7 * len(tracked),
          "16b: the nonplanar run did not track")
    check(res["ate"] is not None and res["ate"] < 0.08 * max(res["span"], 0.1),
          "16b: the nonplanar run's ATE over the bar")


def map_bytes(m):
    """Bytes of a MapState's tensors (what a worker pass copies)."""
    return sum(getattr(m, f.name).numel() * getattr(m, f.name).element_size()
               for f in dataclasses.fields(m))


def gn_ops(a):
    """K4's float32 operations on one recorded call ``a``, counted on its
    data: each iteration the loop runs, at the pose it starts from (the
    plain version after that many iterations). Iteration k ran if the
    plain version after k + 1 iterations has another pose than after k:
    once the loop has settled, the pose stays. Returns (operations,
    iterations run)."""
    import torch

    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.kernels import pose_gn as kpose
    _, cam, size, pts, found, _, _, n_iters, *rest = a
    poses = [kpose.pose_gn_plain(*a[:7], k, *rest)[0]
             for k in range(n_iters + 1)]
    ops = n_run = 0
    for k in range(n_iters):
        if torch.equal(poses[k + 1].R, poses[k].R) and \
                torch.equal(poses[k + 1].t, poses[k].t):
            break
        ok = found & atan.project_points(poses[k], pts, cam, size)[3]
        ops += GN_OPS_ALL * pts.shape[0] + GN_OPS_OK * int(ok.sum())
        n_run += 1
    return ops, n_run


def esm_ops(a):
    """K5's float32 operations on one recorded call ``a`` (moving, target,
    target_jac, iterations), counted on its data: each iteration's warp at
    the SE2 it starts from (the plain version after that many iterations),
    and the pixels of its mask: inside the border, the pixel and its four
    neighbours warped from inside the image."""
    import torch

    from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
    moving, target, jac, n_iter = a
    h, w = moving.shape
    f32 = dict(dtype=torch.float32, device=moving.device)
    ys = torch.arange(h, **f32)[:, None].expand(h, w)
    xs = torch.arange(w, **f32)[None, :].expand(h, w)
    center = torch.stack([xs[0, w // 2], ys[h // 2, 0]])
    ops = 0
    for k in range(n_iter):
        R, t, _ = kesm.esm_plain(moving, target, jac, k)
        t_x = center + t - R @ center
        x0 = torch.floor(R[0, 0] * xs + R[0, 1] * ys + t_x[0])
        y0 = torch.floor(R[1, 0] * xs + R[1, 1] * ys + t_x[1])
        v = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
        ok = (v[1:-1, 1:-1] & v[1:-1, 2:] & v[1:-1, :-2] & v[2:, 1:-1]
              & v[:-2, 1:-1])
        ops += ESM_OPS_ALL * h * w + ESM_OPS_OK * int(ok.sum())
    return ops


def subpix_work(a):
    """K6's float32 operations and bytes on one recorded call ``a``
    (templates, pos0, bounds, windows, origin, max_its, conv_limit,
    patch_size), counted on its data: the preamble of every point, and
    each iteration a point updates (the plain version's position or last
    step changes between that many iterations and one more); the bytes
    read are the templates, starts, bounds and origins, and the window
    pixels under the 7x7 taps of every position a point updates from,
    each once; written, the outputs. Returns (operations, bytes,
    point-iterations)."""
    import torch

    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    tmpl, pos0, bounds, win, origin, max_its, conv_limit, P = a
    N, D = tmpl.shape[0], win.shape[-1]
    runs = [ksubpix.subpix_refine_plain(tmpl, pos0, bounds, win, origin, k,
                                        conv_limit, P)
            for k in range(max_its + 1)]
    taps = torch.zeros((N, D, D), dtype=torch.bool, device=tmpl.device)
    span = torch.arange(P - 1, device=tmpl.device)
    n_it = 0
    for k in range(max_its):
        (p0, _, s0), (p1, _, s1) = runs[k], runs[k + 1]
        moved = (p0 != p1).any(-1) | (s0 != s1)
        n_it += int(moved.sum())
        ib = torch.floor(p0 - P // 2 - origin).long().clamp(0, D - P - 1)
        rows = (ib[:, 1, None] + 1 + span)[:, :, None]
        cols = (ib[:, 0, None] + 1 + span)[:, None, :]
        idx = torch.nonzero(moved)[:, 0]
        taps[idx[:, None, None], rows[idx], cols[idx]] = True
    ops = SUBPIX_OPS_PRE * N + SUBPIX_OPS_IT * n_it
    nbytes = N * (P * P * 4 + 8 + 16 + 8) + int(taps.sum()) * 4 + N * 9
    return ops, nbytes, n_it


def k6_recorder(torch):
    """A context that replaces ``kernels/subpix.subpix_refine`` by a
    recorder: each eager call's arguments are copied into the list it
    yields (not a graph capture's, whose inputs are not written yet)."""
    import contextlib

    from ptam_cg_tpu_torch.kernels import subpix as ksubpix

    @contextlib.contextmanager
    def recording():
        sp, recs = ksubpix.subpix_refine, []

        def rec(*a):
            if not torch.cuda.is_current_stream_capturing():
                recs.append(tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a))
            return sp(*a)
        ksubpix.subpix_refine = rec
        try:
            yield recs
        finally:
            ksubpix.subpix_refine = sp
    return recording()


def k6_against_plain(torch, recs, tag, what, card):
    """K6 on recorded calls ``recs`` (the wrapper's arguments, one shape)
    against the plain loop on the same inputs on the CPU: bit for bit (the
    kernel rounds and sums in its order), each call twice through the
    kernel, bit-identical. Beside it, read and not held to a bar: the plain
    loop on the card, which sums in cuBLAS's order, so it lies as far from
    the CPU's as from K6 (positions, the last step's length, converged sets
    at the limit ``utils/parity.py`` names and elsewhere). Prints a line,
    checks, and returns the largest position difference from the card's
    plain loop."""
    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    from ptam_cg_tpu_torch.utils import parity
    lo, hi = parity.STEP_BAND
    lim_lo, lim_hi = lo * parity.CONV_LIMIT_SQ, hi * parity.CONV_LIMIT_SQ
    d_pos = d_len = d_rel = worst_len = 0.0
    conv_near = conv_far = n_conv = n_pts = n_cpu = n_nan = 0
    same_runs = True

    def same(x, y):                         # NaN where the other has NaN
        return bool(((x == y) | ((x != x) & (y != y))).all())
    for a in recs:
        r1, r2 = ksubpix.subpix_refine(*a), ksubpix.subpix_refine(*a)
        same_runs &= all(same(x, y) for x, y in zip(r1, r2))
        cpu = ksubpix.subpix_refine_plain(
            *[x.cpu() if torch.is_tensor(x) else x for x in a])
        n_cpu += int(all(same(x.cpu(), y) for x, y in zip(r1, cpu)))
        (p, c, st), (pr, cr, sr) = r1, ksubpix.subpix_refine_plain(*a)
        # Compare where both positions are finite; where one is, so must
        # the other be.
        fin_k, fin_p = torch.isfinite(p).all(-1), torch.isfinite(pr).all(-1)
        n_nan += int((fin_k != fin_p).sum())
        fin = fin_k & fin_p
        if not bool(fin.any()):
            continue
        p, pr, c, cr, st, sr = (x[fin] for x in (p, pr, c, cr, st, sr))
        d_pos = max(d_pos, max_abs_diff(p, pr))
        dl = (st.sqrt() - sr.sqrt()).abs()
        if float(dl.max()) >= d_len:
            d_len = float(dl.max())
            worst_len = float(sr.sqrt()[dl.argmax()])
        d_rel = max(d_rel, float(((st - sr).abs()
                                  / sr.clamp_min(1e-30)).max()))
        differ = c != cr
        at = (sr >= lim_lo) & (sr <= lim_hi)
        conv_near += int((differ & at).sum())
        conv_far += int((differ & ~at).sum())
        n_conv += int(c.sum())
        n_pts += int(c.numel())
    a = recs[-1]
    N, D, its = a[0].shape[0], a[3].shape[-1], a[5]
    print(f"[{tag}] K6 {what} calls (N={N} D={D} {its} iterations; "
          f"{len(recs)} calls, {n_conv} of {n_pts} finite points "
          f"converged): two launches bit-identical {same_runs}; equal to "
          f"the plain loop on the CPU bit for bit in {n_cpu} of "
          f"{len(recs)} calls; against the plain loop on the card: "
          f"positions {d_pos:.2e} px, last step's length {d_len:.2e} px "
          f"at a length of {worst_len:.3g} px (squares {d_rel:.2e} "
          f"relative), converged sets differing {conv_near} at the limit, "
          f"{conv_far} elsewhere, finite in one only {n_nan}  [{card}]")
    check(same_runs, f"{tag}: K6's {what} call is not deterministic")
    check(n_cpu == len(recs), f"{tag}: K6's {what} call differs from the "
          f"plain loop on the CPU")
    return d_pos


def pose_kernels_phase(torch, dev, card, kernels, add_row, bound_text,
                       run_frames):
    """Phase 2d: K4 (the Gauss-Newton pose loop), K5 (the SBI ESM) and K6
    (the sub-pixel refinement) on the card against their plain versions,
    on the inputs the tracking
    step gives them: ``run_frames`` reruns phase 4's frames while the
    wrappers are replaced by recorders that keep each call's inputs. Each
    recorded call runs twice through the kernel (bit-identical) and once
    through the plain version (the bars); the last frame's calls are
    timed, and their bounds counted on their data (``gn_ops``,
    ``esm_ops``)."""
    import inspect

    import numpy as np

    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import pose_gn as kpose
    from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    from ptam_cg_tpu_torch.ops import sbi
    from ptam_cg_tpu_torch.utils import se3
    calls = {"gn": [], "esm": [], "subpix": []}
    gn, esm, sp = kpose.pose_gn, kesm.esm, ksubpix.subpix_refine
    gn_args = inspect.signature(gn)

    def kept(args):
        return tuple(x.clone() if torch.is_tensor(x) else x for x in args)

    def rec_gn(*a, **kw):
        # Every argument positionally (the tracker passes some by name).
        bound = gn_args.bind(*a, **kw)
        bound.apply_defaults()
        pose, *rest = bound.arguments.values()
        calls["gn"].append((se3.SE3(pose.R.clone(), pose.t.clone()),
                            *kept(rest)))
        return gn(*a, **kw)

    def rec_esm(*a, **kw):
        calls["esm"].append(kept(a))
        return esm(*a, **kw)

    def rec_sp(*a):
        calls["subpix"].append(kept(a))
        return sp(*a)
    kpose.pose_gn, kesm.esm, ksubpix.subpix_refine = rec_gn, rec_esm, rec_sp
    try:
        run_frames()
    finally:
        kpose.pose_gn, kesm.esm, ksubpix.subpix_refine = gn, esm, sp
    n_frames = len(calls["esm"])
    check(len(calls["gn"]) == len(calls["subpix"]) == 2 * n_frames > 0,
          f"2d: recorded {len(calls['gn'])} K4, {n_frames} K5 and "
          f"{len(calls['subpix'])} K6 calls")

    for what, recs in (("coarse", calls["gn"][0::2]),
                       ("final", calls["gn"][1::2])):
        d_R = d_t = d_w = d_w16 = 0.0
        zero_near = zero_far = 0
        same = True
        for a in recs:
            p1, w1 = kpose.pose_gn(*a)
            p2, w2 = kpose.pose_gn(*a)
            same &= (torch.equal(p1.R, p2.R) and torch.equal(p1.t, p2.t)
                     and torch.equal(w1, w2))
            pr, wr = kpose.pose_gn_plain(*a)
            d_R = max(d_R, max_abs_diff(p1.R, pr.R))
            d_t = max(d_t, max_abs_diff(p1.t, pr.t))
            d_w = max(d_w, max_abs_diff(w1, wr))
            # The bar is K4_W_TOL at sigma^2 = 16, scaled by 16 / sigma^2.
            d_w16 = max(d_w16, max_abs_diff(w1, wr) * a[9] / 16.0)
            other = torch.where(w1 == 0, wr, w1)[(w1 == 0) != (wr == 0)]
            zero_near += int((other <= ZERO_W_MAX).sum())
            zero_far += int((other > ZERO_W_MAX).sum())
        n_found = [int(a[4].sum()) for a in recs]
        a = recs[-1]
        N, sigma_sq = a[3].shape[0], a[9]
        call = lambda _: kpose.pose_gn(*a)              # noqa: E731
        ms_k = time_ms(call, torch)
        plain = time_ms(lambda _: kpose.pose_gn_plain(*a), torch, reps=5)
        dev_k, n_k = device_us(call, torch, match="pose_gn")
        ops, n_last = gn_ops(a)
        # Read: points, found flags, found positions, levels, the pose and
        # the camera's 9 floats; written: weights, the pose.
        nbytes = N * (12 + 1 + 8 + 8 + 4) + 4 * (12 + 9 + 12)
        add_row(kernels["pose_gn"], ms_k, plain, dev_k, nbytes, ops,
                err=max(d_R, d_t))
        print(f"[2d] K4 {what} call N={N} on phase 4's {len(recs)} frames "
              f"({min(n_found)}-{max(n_found)} found points a call): "
              f"two launches bit-identical {same}; kernel vs plain: pose "
              f"|dR| {d_R:.2e} |dt| {d_t:.2e} (bar {POSE_TOL:.0e}), weights "
              f"{d_w:.2e} (bar {K4_W_TOL * 16.0 / sigma_sq:.1e} at sigma^2 "
              f"{sigma_sq:g}), zero-weight differences {zero_near} at "
              f"err^2 ~ sigma^2, {zero_far} elsewhere (bar 0); the last "
              f"frame's call: kernel {ms_k:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events), device {fmt_us(dev_k)} in {n_k:.0f} launch, "
              f"{bound_text(nbytes, ops)} over the {n_last} iterations the "
              f"plain version runs; "
              f"launches a frame 1  [{card}]")
        check(min(n_found) > 0, f"2d: a K4 {what} call had no found point")
        check(same, f"2d: K4's {what} call is not deterministic")
        check(d_R <= POSE_TOL and d_t <= POSE_TOL,
              f"2d: K4's {what} pose differs from its plain version")
        check(d_w16 <= K4_W_TOL and zero_far == 0,
              f"2d: K4's {what} weights differ from its plain version")

    d_R = d_t = d_s = 0.0
    same = True
    for a in calls["esm"]:
        r1, r2 = kesm.esm(*a), kesm.esm(*a)
        same &= all(torch.equal(x, y) for x, y in zip(r1, r2))
        ref = kesm.esm_plain(*a)
        d_R = max(d_R, max_abs_diff(r1[0], ref[0]))
        d_t = max(d_t, max_abs_diff(r1[1], ref[1]))
        d_s = max(d_s, abs(float(r1[2]) - float(ref[2]))
                  / max(abs(float(ref[2])), 1.0))
    a = calls["esm"][-1]
    h, w = a[0].shape
    call = lambda _: kesm.esm(*a)                       # noqa: E731
    ms_k = time_ms(call, torch)
    plain = time_ms(lambda _: kesm.esm_plain(*a), torch, reps=5)
    dev_k, n_k = device_us(call, torch, match="sbi_esm")
    # Read: two templates and the target's gradients; written: R, t, score.
    nbytes, ops = h * w * 16 + 28, esm_ops(a)
    add_row(kernels["sbi_esm"], ms_k, plain, dev_k, nbytes, ops,
            err=max(d_R, d_t))
    print(f"[2d] K5 {h}x{w} SBIs of phase 4's {n_frames} frames (each "
          f"against its predecessor's): two launches bit-identical {same}; "
          f"kernel vs plain: |dR| {d_R:.2e} |dt| {d_t:.2e} (bar "
          f"{SE2_TOL:.0e}), score {d_s:.2e} relative (bar 1e-4); the last "
          f"frame's call: kernel {ms_k:.4f} ms, plain {plain:.4f} ms (CUDA "
          f"events), device {fmt_us(dev_k)} in {n_k:.0f} launch, "
          f"{bound_text(nbytes, ops)}; launches a frame 1, a relocalization "
          f"1  [{card}]")
    check(same, "2d: K5 is not deterministic")
    check(d_R <= SE2_TOL and d_t <= SE2_TOL and d_s <= 1e-4,
          "2d: K5 differs from its plain version")
    tex = synth.make_texture(np.random.default_rng(1), device=dev)
    for h, w, frame in ((45, 80, "1280x720"), (67, 120, "1920x1080")):
        moving, target = [sbi.make_sbi(tex[y: y + 2 * h, x: x + 2 * w], 0.75)
                          for y, x in ((40, 60), (42, 57))]
        a = (moving.template, target.template, target.jac, 10)
        r1, r2, ref = kesm.esm(*a), kesm.esm(*a), kesm.esm_plain(*a)
        same = all(torch.equal(x, y) for x, y in zip(r1, r2))
        d_R, d_t = max_abs_diff(r1[0], ref[0]), max_abs_diff(r1[1], ref[1])
        d_s = abs(float(r1[2]) - float(ref[2])) / max(abs(float(ref[2])), 1.0)
        print(f"[2d] K5 at {h}x{w} (the SBI of a {frame} frame; "
              f"{h * w * 21 / 1024:.0f} kB of shared memory): two "
              f"launches bit-identical {same}; kernel vs plain: |dR| "
              f"{d_R:.2e} |dt| {d_t:.2e} (bar {SE2_TOL:.0e}), score {d_s:.2e} "
              f"relative (bar 1e-4)  [{card}]")
        check(same and d_R <= SE2_TOL and d_t <= SE2_TOL and d_s <= 1e-4,
              f"2d: K5 at {h}x{w} differs from its plain version")
    for what, recs in (("coarse", calls["subpix"][0::2]),
                       ("fine", calls["subpix"][1::2])):
        d_pos = k6_against_plain(torch, recs, "2d", what, card)
        a = recs[-1]
        N, D, its = a[0].shape[0], a[3].shape[-1], a[5]
        call = lambda _: ksubpix.subpix_refine(*a)      # noqa: E731
        ms_k = time_ms(call, torch)
        plain = time_ms(lambda _: ksubpix.subpix_refine_plain(*a), torch,
                        reps=5)
        dev_k, n_k = device_us(call, torch, match="subpix")
        ops, nbytes, n_it = subpix_work(a)
        add_row(kernels["subpix"], ms_k, plain, dev_k, nbytes, ops,
                err=d_pos)
        print(f"[2d] K6 {what} call N={N} D={D} {its} iterations, the last "
              f"of phase 4's {len(recs)} frames: kernel {ms_k:.4f} ms, plain "
              f"{plain:.4f} ms (CUDA events), device {fmt_us(dev_k)} in "
              f"{n_k:.0f} launch, {bound_text(nbytes, ops)} over the {n_it} "
              f"point-iterations that update; launches a frame 1  [{card}]")

    for name in ("pose_gn", "sbi_esm", "subpix"):
        k = kernels[name]
        print(f"[2d] {name} summed over a tracked frame's calls: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms (CUDA "
              f"events); device {fmt_us(k['device_us'])}; bound "
              f"{k['bound_us']:.3f} us ({k['bound_by']}); "
              f"{k['launches_per_frame']} launches a frame")


def bf16_phase(torch, dev, card, kernels, entry, add_row, bound_text,
               reset_counts, counts, ph11):
    """Phase 19: the bf16 frontend configuration (``FrontendConfig(
    atlas_bf16=True)``, ``TrackerConfig(zmssd_bf16_cross=True)``). K2's
    bf16-source instantiation against its plain version at every path
    shape (bit for bit), timed; then ``SLAMEngine.process_frame`` under
    the configuration on phase 11's 240 frames: deterministic on the card
    (every tracked frame GOOD, phase 11a's bars, launch counts), card =
    CPU in outcome through two scheduler-integrated keyframes (11b's
    bars), and the card's latency mode (p50, p95, FPS beside 11c's
    float32 numbers); the map's bytes and a worker copy's time, float32
    and bf16."""
    import numpy as np
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          FrontendConfig, MapMakerConfig,
                                          TrackerConfig)
    from ptam_cg_tpu_torch.kernels import gather as kgather
    from ptam_cg_tpu_torch.models import engine as englib
    from ptam_cg_tpu_torch.models import map_state as ms

    k = kernels["gather_windows_bf16"] = entry(
        "gather_windows_bf16", "ptam_cg_tpu_torch/csrc/gather_windows.cu",
        "ptam_cg_tpu/ops/pallas_gather.py:50", 4, 2 + 3 * 4, True)
    bf16 = kgather.bf16_source

    # ---- 19a. K2 on bf16 atlases, at the path's shapes ----
    rng = np.random.default_rng(19)
    W, H = SIZE
    Ha, Wa = H * 3 // 2, W
    gen = torch.Generator(device=dev).manual_seed(19)
    frame_atlas = (torch.rand(Ha, Wa, device=dev, generator=gen) * 255
                   ).round().to(torch.bfloat16)
    frame_mask = frame_atlas > 200.0
    kf_atlases = (torch.rand(4 * Ha, Wa, device=dev, generator=gen) * 255
                  ).round().to(torch.bfloat16)

    def origins(src, n, D):
        h, w = src.shape
        org = np.stack([rng.integers(-8, h - D + 8, n),
                        rng.integers(-8, w - D + 8, n)], -1)
        org[:4] = [[-3, -3], [h, w], [h - D, -1], [0, w - D + 1]]
        org = torch.from_numpy(org).to(dev)
        return org[:, 0], org[:, 1]

    def forms(oy, ox):
        return ((oy, ox), (oy.contiguous(), ox.contiguous()),
                (oy.to(torch.int32), ox.to(torch.int32)))

    def library(a, oy, ox, D, cast=True):
        """PyTorch calls for the same windows: an unfolded view indexed at
        the clamped origins, then (``cast``) cast to float32."""
        h, w = a.shape
        oy, ox = oy.clamp(0, h - D), ox.clamp(0, w - D)
        view = a.unfold(0, D, 1).unfold(1, D, 1)
        if cast:
            return lambda _: view[oy, ox].to(torch.float32)
        return lambda _: view[oy, ox]

    def win_bytes(src, oy, ox, D, es_in, es_out):
        return (covered(src.shape, oy, ox, D) * es_in
                + oy.numel() * D * D * es_out)

    singles = [(kf_atlases, 128, 28, "coarse templates", 1, 0),
               (kf_atlases, 1024, 28, "fine templates", 1, 0),
               (kf_atlases, 2048, 28, "re-find templates", 0, 1),
               (kf_atlases, 512, 28, "epipolar templates", 0, 4),
               (frame_atlas, 2048, 8, "epipolar corner patches", 0, 4),
               (frame_atlas, 512, 15, "sub-pixel window", 0, 4),
               (frame_atlas, 512, 9, "MiniPatch cuts", 0, 0),
               (frame_atlas, 512, 8, "template cuts", 0, 0)]
    for src, n, D, what, per_frame, per_kf in singles:
        oy, ox = origins(src, n, D)
        for o in forms(oy, ox):
            got = kgather.gather_windows(src, *o, D)
            ref = kgather.gather_windows_plain(src, *o, D)
            check(got.dtype == torch.float32 and torch.equal(got, ref),
                  f"K2 bf16 differs from its plain version: {what} "
                  f"{o[0].dtype} {o[0].stride()}")
        check(torch.equal(got, library(src, oy, ox, D)(None)),
              f"the library call differs from K2 bf16: {what}")
        call = lambda _, a=src, y=oy, x=ox, d=D: kgather.gather_windows(
            a, y, x, d)
        ms_k = time_ms(call, torch)
        plain = time_ms(lambda _: kgather.gather_windows_plain(src, oy, ox,
                                                               D), torch)
        lib = time_ms(library(src, oy, ox, D), torch)
        dev_k, _ = device_us(call, torch, match="gather_")
        dev_l, n_l = device_us(library(src, oy, ox, D), torch)
        nbytes = win_bytes(src, oy, ox, D, 2, 4) + n * 16
        if per_frame:
            add_row(k, ms_k, plain, dev_k, nbytes, 0, lib)
        print(f"[19a] K2 bf16 {what} N={n} D={D}: bit-identical (int64 and "
              f"int32 origins, strided and contiguous); kernel {ms_k:.4f} "
              f"ms, plain {plain:.4f} ms, library (two calls) {lib:.4f} ms "
              f"(CUDA events); device: kernel {fmt_us(dev_k)}, library "
              f"{fmt_us(dev_l)} ({n_l:.0f} kernels); {bound_text(nbytes, 0)};"
              f" launches a frame {per_frame}, a keyframe {per_kf}  [{card}]")
    pairs = [(128, 40, 33, "coarse search", 1, 0),
             (1024, 30, 23, "fine search", 1, 0),
             (2048, 16, 9, "re-find search", 0, 1),
             (512, 29, 21, "trail search", 0, 0)]
    for n, D, M, what, per_frame, per_kf in pairs:
        oy, ox = origins(frame_atlas, n, D)
        oy.clamp_(0, Ha - D)
        ox.clamp_(0, Wa - D)
        for o in forms(oy, ox):
            got = kgather.gather_window_pair(frame_atlas, frame_mask, *o, D,
                                             4, M)
            ref = kgather.gather_window_pair_plain(frame_atlas, frame_mask,
                                                   *o, D, 4, M)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"K2 bf16 pair differs from its plain version: {what} "
                  f"{o[0].dtype} {o[0].stride()}")
        lib_img = library(frame_atlas, oy, ox, D)
        lib_msk = library(frame_mask, oy + 4, ox + 4, M, cast=False)
        check(torch.equal(lib_img(None), got[0]),
              f"the library call differs from the K2 bf16 pair: {what}")
        pair = (lambda _, y=oy, x=ox, d=D, m_=M: kgather.gather_window_pair(
            frame_atlas, frame_mask, y, x, d, 4, m_))
        ms_k = time_ms(pair, torch)
        plain = time_ms(lambda _: kgather.gather_window_pair_plain(
            frame_atlas, frame_mask, oy, ox, D, 4, M), torch)
        lib = time_ms(lambda _: (lib_img(None), lib_msk(None)), torch)
        dev_k, n_k = device_us(pair, torch, match="gather_")
        nbytes = (win_bytes(frame_atlas, oy, ox, D, 2, 4)
                  + win_bytes(frame_mask, oy + 4, ox + 4, M, 1, 1) + n * 16)
        if per_frame:
            add_row(k, ms_k, plain, dev_k, nbytes, 0, lib)
        print(f"[19a] K2 bf16 pair {what} N={n} D={D} bf16 -> f32 + M={M} "
              f"bool: bit-identical; one launch ({n_k:.0f} kernels a call); "
              f"kernel {ms_k:.4f} ms, plain {plain:.4f} ms, library (three "
              f"calls: the image windows and their cast, the mask windows) "
              f"{lib:.4f} ms (CUDA events); device {fmt_us(dev_k)}; "
              f"{bound_text(nbytes, 0)}; launches a frame {per_frame}, a "
              f"keyframe {per_kf}  [{card}]")
    print(f"[19a] K2 bf16 summed over a tracked frame's calls: kernel "
          f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
          f"{k['library_ms']:.4f} ms (CUDA events); device "
          f"{fmt_us(k['device_us'])}; bound {k['bound_us']:.3f} us "
          f"(float32 K2 over the same calls: "
          f"{kernels['gather_windows']['bound_us']:.3f} us)  [{card}]")

    # ---- 19b-d. the engine under the bf16 configuration ----
    frames, seq = ph11["frames"], ph11["seq"]
    targets, expected = ph11["targets"], ph11["expected"]

    def make(device, **kw):
        cfg = EngineConfig(
            camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
            mapmaker=MapMakerConfig(
                candidate_min_shi_tomasi_score=ENG_CAND_MIN),
            frontend=FrontendConfig(atlas_bf16=True),
            tracker=TrackerConfig(zmssd_bf16_cross=True))
        return englib.SLAMEngine(cfg, image_size=SIZE, device=device,
                                 **ENG_MAP, **kw)

    def engine_run(eng, ims, times=None):
        """``run`` with K1-K6 and the bf16 K2 launches counted; returns
        (infos, launches, expected launches, bf16 K2 launches)."""
        torch.cuda.synchronize()
        reset_counts()
        bf16.launches = 0
        bf16.launches_by_stream.clear()
        with CallCounts(targets) as calls:
            infos = run(eng, ims, times)
            torch.cuda.synchronize()
        launches = counts()
        return infos, launches, expected(calls.n), bf16.launches

    eng = make(dev, deterministic=True, draws=HostDraws(englib, 0, dev))
    t0 = time.perf_counter()
    card_a, launches, want, n16 = engine_run(eng, frames)
    a_s = time.perf_counter() - t0
    check(eng.map.kf_atlas.dtype == torch.bfloat16,
          "19b: the engine's map is not bf16")
    print(f"[19b] bf16 configuration, {len(frames)} frames, deterministic: "
          f"{a_s:.1f} s (host clock); launches {launches}, expected {want}, "
          f"K2 launches on bf16 atlases {n16}  [{card}]")
    check(launches == want, "19b: launch counts differ")
    check(n16 == launches["gather_windows"] > 0,
          "19b: a K2 launch of the bf16 engine did not read a bf16 atlas")
    k["launches"] += n16
    first = engine_outcome(card_a, seq, torch, "19b")
    not_good = [i for i, x in enumerate(card_a[first:], first)
                if x.quality != 2]
    check(not not_good, f"19b: tracked frames not GOOD: {not_good}")
    f32_a = ph11.get("card_a")
    if f32_a is not None:
        same = sum(x.stage == y.stage and x.n_kfs == y.n_kfs
                   for x, y in zip(card_a, f32_a))
        med16, med32 = (statistics.median(x.n_found for x in run_[first:])
                        for run_ in (card_a, f32_a))
        print(f"[19b] against 11a's float32 run: {same}/{len(frames)} "
              f"frames with the same stage and keyframe count; found a "
              f"tracked frame median {med16} vs {med32}")

    # 19c: card against CPU through two scheduler-integrated keyframes.
    n_c = next((j + 1 for j, x in enumerate(card_a) if x.n_kfs >= 4), None)
    check(n_c is not None, "19b: fewer than two keyframes integrated")
    t0 = time.perf_counter()
    cpu = run(make("cpu", deterministic=True,
                   draws=HostDraws(englib, 0, "cpu")), frames[:n_c])
    cpu_s = time.perf_counter() - t0
    par = engine_parity(card_a[:n_c], cpu, first, torch)
    print(f"[19c] card vs CPU over frames 0..{n_c - 1}: outcome differences "
          f"{par[0]}; {fmt_parity(par)}; CPU {cpu_s:.1f} s")
    check_engine_parity("19c", par)

    # 19d: the card's latency mode.
    eng, times = make(dev), []
    t0 = time.perf_counter()
    lat, launches, want, n16 = engine_run(eng, frames, times)
    wall = time.perf_counter() - t0
    check(launches == want, f"19d: launch counts {launches} differ from "
          f"{want}")
    check(n16 == launches["gather_windows"], "19d: a K2 launch of the bf16 "
          "engine did not read a bf16 atlas")
    k["launches"] += n16
    engine_outcome(lat, seq, torch, "19d")
    c = latency_stats(lat, times)
    c.update(fps=len(frames) / wall)
    f32 = ph11["sync"]
    print(f"[19d] bf16 configuration, latency mode, {len(frames)} frames: "
          f"p50 {c['p50']:.1f} ms, p95 {c['p95']:.1f} ms, max "
          f"{c['max']:.1f} ms over {c['n']} frames; {len(c['kf_frames'])} "
          f"keyframe frames; {c['fps']:.2f} FPS (float32, 11c over its first "
          f"{len(frames) - ENG_PROFILE - ENG_SYNC} frames: p50 "
          f"{f32['p50']:.1f}, p95 {f32['p95']:.1f} ms, {f32['fps']:.2f} FPS)"
          f"; K2 launches {n16}  [{card}]")
    print_captures("19d", eng)

    # The map's bytes and what a worker pass's copy of it costs.
    maps = {"float32": ms.empty_map(SIZE, ENG_MAP["max_points"],
                                    ENG_MAP["max_kfs"], dev),
            "bf16": eng.snapshot()}
    for tag, m in maps.items():
        copy_ms = time_ms(lambda _, m=m: ms.copy_map(m), torch)
        dev_c, n_c = device_us(lambda _, m=m: ms.copy_map(m), torch)
        print(f"[19d] a {tag} map ({ENG_MAP['max_points']} points, "
              f"{ENG_MAP['max_kfs']} keyframes): {map_bytes(m) / 1e6:.3f} "
              f"MB, of which keyframe atlases "
              f"{m.kf_atlas.numel() * m.kf_atlas.element_size() / 1e6:.3f} "
              f"MB; a copy (``copy_map``, a worker pass's) {copy_ms:.4f} ms "
              f"(CUDA events), device {fmt_us(dev_c)} in {n_c:.0f} kernels"
              f"  [{card}]")


def main():
    t_script = time.perf_counter()
    faulthandler.enable()       # a crash prints every thread's traceback
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import numpy as np

    from ptam_cg_tpu_torch.config import FrontendConfig, MapMakerConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import _build
    from ptam_cg_tpu_torch.kernels import fast as kfast
    from ptam_cg_tpu_torch.kernels import gather as kgather
    from ptam_cg_tpu_torch.kernels import pose_gn as kpose
    from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
    from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi
    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    from ptam_cg_tpu_torch.models import graphs
    from ptam_cg_tpu_torch.models import keyframe as kflib
    from ptam_cg_tpu_torch.models import map_state as ms
    from ptam_cg_tpu_torch.models import mapmaker, tracker
    from ptam_cg_tpu_torch.ops import image as imops
    from ptam_cg_tpu_torch.ops import levels as levelops
    from ptam_cg_tpu_torch.utils import parity, se3
    from ptam_cg_tpu_torch.utils.tree import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mods = {"fast10": kfast, "gather_windows": kgather, "shi_tomasi": kshi,
            "pose_gn": kpose, "sbi_esm": kesm, "subpix": ksubpix}

    def reset_launch_counts():
        graphs.settle_launches()
        for mod in mods.values():
            mod.launches = 0
            mod.launches_by_stream.clear()

    def launch_counts():
        graphs.settle_launches()
        return {name: mod.launches for name, mod in mods.items()}

    # ---- 1. device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    builds = [(name, ()) for name in KERNELS] + [
        ("shi_tomasi", v) for v in ST_VARIANTS if v] + [(GRAPH_COND, ())]
    _build.load_all(builds)
    print(f"[1] built and loaded {len(KERNELS)} kernels, "
          f"{len(builds) - len(KERNELS) - 1} variants of K3 and the graphs' "
          f"conditional-node helper in {time.perf_counter() - t0:.1f} s")
    for name, v in builds:
        seconds, log = _build.build_info(name, v)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[1] {name} {' '.join(v)}: nvcc {seconds:.1f} s; "
              f"{' | '.join(regs)}")

    def entry(name, source, replaces, per_frame, per_keyframe, library):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                    bound_ms=0.0, bound_by="bytes",
                    library_ms=0.0 if library else None, device_us=0.0,
                    bound_us=0.0, launches_per_frame=per_frame,
                    launches_per_keyframe=per_keyframe,
                    launches_by_stream_async={})

    # Launches on the tracking path (per frame) and on the keyframe path
    # (build_frame + integrate_keyframe_program); phases 4 and 6 hold the
    # run's counts to these.
    kernels = {
        "fast10": entry("fast10", "ptam_cg_tpu_torch/csrc/fast10.cu",
                        "ptam_cg_tpu/ops/pallas_kernels.py:241", 1, 1,
                        False),
        "gather_windows": entry(
            "gather_windows", "ptam_cg_tpu_torch/csrc/gather_windows.cu",
            "ptam_cg_tpu/ops/pallas_gather.py:50", 4, 2 + 3 * 4, True),
        "shi_tomasi": entry("shi_tomasi",
                            "ptam_cg_tpu_torch/csrc/shi_tomasi.cu",
                            "ptam_cg_tpu/ops/pallas_kernels.py:326", 0, 1,
                            False),
        # The JAX package's two heaviest loops of the tracking program.
        "pose_gn": entry("pose_gn", "ptam_cg_tpu_torch/csrc/pose_gn.cu",
                         "ptam_cg_tpu/models/tracker.py:321", 2, 0, False),
        "sbi_esm": entry("sbi_esm", "ptam_cg_tpu_torch/csrc/sbi_esm.cu",
                         "ptam_cg_tpu/ops/sbi.py:64", 1, 0, False),
        # The sub-pixel refinement: twice a tracked frame; once in the
        # re-find and once in each of the 4 epipolar levels a keyframe.
        "subpix": entry("subpix", "ptam_cg_tpu_torch/csrc/subpix.cu",
                        "ptam_cg_tpu/ops/patch.py:381", 2, 1 + 4, False)}

    def add_row(k, ms_k, plain, dev_k, nbytes, ops, lib=None, err=0.0):
        """Add one path call's numbers to kernel k's summary; returns its
        bound in us (bytes over the HBM rate, f32 operations over the f32
        peak, the larger)."""
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
        bound = max(t_bytes, t_ops) * 1e6
        k["ms"] += ms_k
        k["plain_ms"] += plain
        if dev_k is None or k["device_us"] is None:
            k["device_us"] = None
        else:
            k["device_us"] += dev_k
        k["bound_us"] += bound
        k["bound_ms"] = k["bound_us"] / 1e3
        if t_ops > t_bytes:
            k["bound_by"] = "operations"
        if lib is not None:
            k["library_ms"] += lib
        k["max_abs_err"] = max(k["max_abs_err"], err)
        return bound

    def bound_text(nbytes, ops):
        return (f"bound {max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e6:.3f}"
                f" us ({nbytes / 1e6:.3f} MB -> "
                f"{nbytes / HBM_BYTES_S * 1e6:.3f} us, {ops / 1e6:.2f} M f32 "
                f"ops -> {ops / F32_OPS_S * 1e6:.3f} us)")

    # ---- 2. K1 against its plain version ----
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                  n_frames=N_FRAMES + 1, seed=7, height=1.5,
                                  radius=0.2, sweep=0.6, device=dev)
    thresholds = FrontendConfig().fast_thresholds
    pyramid = imops.build_pyramid(seq.frame(0), 4)
    atlas = levelops.pack_atlas(pyramid)
    k = kernels["fast10"]
    ref = kfast.fast_atlas_plain(atlas, thresholds, scores=True)
    for scores in (False, True):
        got = kfast.fast_atlas(atlas, thresholds, scores=scores)
        for name, g, r, want in (("mask", got[0], ref[0], True),
                                 ("score", got[1], ref[1], scores),
                                 ("counts", got[2], ref[2], scores)):
            if want:
                check(torch.equal(g, r), f"K1 {name} differs from its plain "
                      f"version (scores={scores}): {max_abs_diff(g, r)}")
            else:
                check(g is None, f"K1 wrote {name} unasked")
    n_inner, n_polar = fast_work(pyramid, thresholds, torch)
    in_bytes = sum(im.numel() for im in pyramid) * 4     # the levels' pixels
    print(f"[2] K1 640x480 atlas {tuple(atlas.shape)}: bit-identical (mask, "
          f"scores, counts {ref[2].tolist()}, with and without scores); "
          f"{n_inner} pixels inside the levels, {n_polar} polarities past "
          f"the compass test")
    for what, score in (("tracking (mask)", False),
                        ("keyframe (mask, scores, counts)", True)):
        call = (lambda _, s=score: kfast.fast_atlas(atlas, thresholds,
                                                    scores=s))
        plain_call = (lambda _, s=score: kfast.fast_atlas_plain(
            atlas, thresholds, scores=s))
        ms_k = time_ms(call, torch)
        plain = time_ms(plain_call, torch)
        dev_k, n_k = device_us(call, torch, match="fast10")
        # Written: the mask atlas; with scores the score atlas and counts.
        nbytes = in_bytes + atlas.numel() * (5 if score else 1) + (
            16 if score else 0)
        ops = n_inner * 11 + n_polar * 81 + (int(ref[2].sum()) if score
                                             else 0)
        if not score:
            add_row(k, ms_k, plain, dev_k, nbytes, ops)
        print(f"[2] K1 {what}: kernel {ms_k:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events); device {fmt_us(dev_k)} in {n_k:.0f} launch; "
              f"{bound_text(nbytes, ops)}; launches a frame "
              f"{1 if not score else 0}, a keyframe {1 if score else 0}"
              f"  [{card}]")

    # K1 on one image (``ops/fast.detect``): a table of one level.
    from ptam_cg_tpu_torch.ops import fast as fastops
    im0, t_det = pyramid[0], float(thresholds[0])
    got = kfast.fast_image(im0, t_det)
    ref = kfast.fast_score_map_plain(im0, t_det)
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          "K1 on one image differs from its plain version: "
          f"{max_abs_diff(got[1], ref[1])}")
    det = fastops.detect(im0, t_det, DETECT_CAP)
    det_cpu = fastops.detect(im0.cpu(), t_det, DETECT_CAP)
    check(all(torch.equal(x.cpu(), y) for x, y in zip(
        (det[0], det[1], *det[2]), (det_cpu[0], det_cpu[1], *det_cpu[2]))),
        "ops/fast.detect on the card differs from the CPU's")
    call = lambda _: kfast.fast_image(im0, t_det)      # noqa: E731
    ms_k = time_ms(call, torch)
    plain = time_ms(lambda _: kfast.fast_score_map_plain(im0, t_det), torch)
    dev_k, n_k = device_us(call, torch, match="fast10")
    n_inner, n_polar = fast_work([im0], [t_det], torch)
    # Read: the image; written: the mask, the score and the counts.
    nbytes = im0.numel() * (4 + 1 + 4) + 16
    ops = n_inner * 11 + n_polar * 81 + int(got[0].sum())
    print(f"[2] K1 on one {SIZE[0]}x{SIZE[1]} image (ops/fast.detect, off "
          f"the path): bit-identical (mask, score), detect card = CPU "
          f"({int(det[2].count)} corners of {DETECT_CAP}); kernel "
          f"{ms_k:.4f} ms, plain {plain:.4f} ms (CUDA events); device "
          f"{fmt_us(dev_k)} in {n_k:.0f} launch; {bound_text(nbytes, ops)}; "
          f"launches on the engine's path 0  [{card}]")

    # ---- 2b. K3 against its plain version ----
    k = kernels["shi_tomasi"]
    st_atlases = ((f"{SIZE[0]}x{SIZE[1]} frame", atlas),
                  ("bordered", bordered_atlas(SIZE, 4, dev)))
    err = 0.0
    for what, a in st_atlases:
        ref = kshi.shi_tomasi_atlas_plain(a)
        before = kshi.launches
        got = kshi.shi_tomasi_atlas(a)
        err = max(err, max_abs_diff(got, ref))
        check(kshi.launches == before + 1,
              "K3 did not make exactly one launch")
        check(torch.equal(got, ref),
              f"K3 differs from its plain version on the {what} atlas: "
              f"{err}, {int((got != ref).sum())} pixels")
        print(f"[2b] K3 {what} atlas {tuple(a.shape)}: bit-identical in one "
              f"launch; {int((ref > CAND_MIN).sum())} px above {CAND_MIN}")
    call = lambda _: kshi.shi_tomasi_atlas(atlas)      # noqa: E731
    plain_call = lambda _: kshi.shi_tomasi_atlas_plain(atlas)  # noqa: E731
    ms_k = time_ms(call, torch)
    plain = time_ms(plain_call, torch)
    dev_k, n_k = device_us(call, torch, match="shi_tomasi")
    dev_p, n_p = device_us(plain_call, torch)
    # Read: the levels' pixels; written: the score atlas, each once.
    n_levels = sum(im.numel() for im in pyramid)
    nbytes, ops = (n_levels + atlas.numel()) * 4, n_levels * SHI_OPS
    add_row(k, ms_k, plain, dev_k, nbytes, ops, err=err)
    print(f"[2b] K3 one call over the atlas: kernel {ms_k:.4f} ms, plain "
          f"{plain:.4f} ms (CUDA events); device: kernel {fmt_us(dev_k)} in "
          f"{n_k:.0f} launch, plain {fmt_us(dev_p)} ({n_p:.0f} kernels); "
          f"{bound_text(nbytes, ops)} (the levels' pixels read and written "
          f"alone: {bound_text(n_levels * 8, ops)}); launches a keyframe 1"
          f"  [{card}]")

    # The wrappers' host path: what a call costs the host, whole and in
    # parts (K3's checks and level table are the rest).
    fn = kshi._lib()
    out = torch.empty_like(atlas)
    rects = kshi._rects_arg(tuple(atlas.shape))
    stream = _build.stream_handle(atlas)
    gen = torch.Generator().manual_seed(5)
    g_org = torch.stack([
        torch.randint(0, atlas.shape[0] - 15, (512,), generator=gen),
        torch.randint(0, atlas.shape[1] - 15, (512,), generator=gen)],
        -1).to(dev)
    parts = {
        "shi_tomasi_atlas": lambda: kshi.shi_tomasi_atlas(atlas),
        "gather_windows N=512 D=15": lambda: kgather.gather_windows(
            atlas, g_org[:, 0], g_org[:, 1], 15),
        "K3 ctypes call alone": lambda: fn(atlas.data_ptr(), *atlas.shape,
                                           rects, out.data_ptr(), stream),
        "torch.empty": lambda: torch.empty_like(atlas),
        "_build.stream_handle": lambda: _build.stream_handle(atlas),
    }
    times = "; ".join(f"{name} {host_us(f, torch):.2f}"
                      for name, f in parts.items())
    print(f"[2b] host us a call ({HOST_CALLS} back-to-back calls, one sync): "
          f"{times}  [{card}]")

    # ---- 2c. K3 tile-shape variants (off the main path) ----
    sweep = {v: [] for v in ST_VARIANTS}
    for v in ST_VARIANTS:
        for what, a in st_atlases:
            check(torch.equal(kshi.shi_tomasi_atlas(a, defines=v),
                              kshi.shi_tomasi_atlas_plain(a)),
                  f"K3 variant {v} differs from the plain version ({what})")
    for order in (ST_VARIANTS, ST_VARIANTS[::-1]):
        for v in order:
            sweep[v].append(device_us(
                lambda _, v=v: kshi.shi_tomasi_atlas(atlas, defines=v),
                torch, match="shi_tomasi")[0])
    for v, (a_us, b_us) in sweep.items():
        ms_v = time_ms(lambda _, v=v: kshi.shi_tomasi_atlas(atlas, defines=v),
                       torch)
        print(f"[2c] K3 {' '.join(v) or 'default'}: bit-identical on both "
              f"atlases; device {fmt_us(a_us)} / {fmt_us(b_us)} (two rounds), "
              f"{ms_v:.4f} ms (CUDA events)  [{card}]")

    # ---- 3. K2 against its plain version ----
    rng = np.random.default_rng(3)
    Ha, Wa = SIZE[1] * 3 // 2, SIZE[0]
    frame_atlas = torch.rand(Ha, Wa, device=dev) * 255
    frame_mask = frame_atlas > 200.0
    kf_atlases = torch.rand(4 * Ha, Wa, device=dev) * 255

    def origins(src, n, D):
        H, W = src.shape
        org = np.stack([rng.integers(-8, H - D + 8, n),
                        rng.integers(-8, W - D + 8, n)], -1)
        org[:4] = [[-3, -3], [H, W], [H - D, -1], [0, W - D + 1]]
        org = torch.from_numpy(org).to(dev)        # int64, as the path
        return org[:, 0], org[:, 1]

    def library(a, oy, ox, D):
        """One PyTorch call for the same windows: an unfolded view indexed
        at the clamped origins (timed as a yardstick, never used)."""
        H, W = a.shape
        oy = oy.clamp(0, H - D)
        ox = ox.clamp(0, W - D)
        view = a.unfold(0, D, 1).unfold(1, D, 1)
        return lambda _: view[oy, ox]

    def win_bytes(src, oy, ox, D, es):
        """The source bytes under the windows, read once, and the windows
        written once."""
        return (covered(src.shape, oy, ox, D) + oy.numel() * D * D) * es

    k = kernels["gather_windows"]
    # (source, N, window side, what, the dtype the path gathers there,
    #  launches a frame, a keyframe; the bootstrap path's shapes, with
    #  the launches a trail-tracking frame and an init, after them)
    singles = [(kf_atlases, 128, 28, "coarse templates", "f32", 1, 0),
               (kf_atlases, 1024, 28, "fine templates", "f32", 1, 0),
               (kf_atlases, 2048, 28, "re-find templates", "f32", 0, 1),
               (kf_atlases, 512, 28, "epipolar templates", "f32", 0, 4),
               (frame_atlas, 2048, 8, "epipolar corner patches", "f32", 0, 4),
               (frame_atlas, 512, 15, "sub-pixel window", "f32", 0, 4),
               (frame_atlas, 512, 9, "MiniPatch cuts (trails: 1 a frame)",
                "f32", 0, 0),
               (frame_atlas, 512, 8, "template cuts (init: 1)", "f32", 0,
                0)]
    def forms(oy, ox):
        """The origin columns as the path holds them (int64 views of one
        (N, 2) tensor), contiguous, and int32."""
        return ((oy, ox), (oy.contiguous(), ox.contiguous()),
                (oy.to(torch.int32), ox.to(torch.int32)))

    for src, n, D, what, path_dtype, per_frame, per_kf in singles:
        oy, ox = origins(src, n, D)
        for dtype, a in (("f32", src), ("bool", src > 200.0)):
            for o in forms(oy, ox):
                got = kgather.gather_windows(a, *o, D)
                ref = kgather.gather_windows_plain(a, *o, D)
                check(torch.equal(got, ref), f"K2 differs from its plain "
                      f"version: {what} {dtype} {o[0].dtype} "
                      f"{o[0].stride()}")
            check(torch.equal(got, library(a, oy, ox, D)(None)),
                  f"the library call differs from K2: {what} {dtype}")
        a = src
        ms_k = time_ms(lambda _: kgather.gather_windows(a, oy, ox, D), torch)
        plain = time_ms(lambda _: kgather.gather_windows_plain(a, oy, ox, D),
                        torch)
        lib = time_ms(library(a, oy, ox, D), torch)
        dev_k, _ = device_us(lambda _: kgather.gather_windows(a, oy, ox, D),
                             torch, match="gather_")
        dev_l, n_l = device_us(library(a, oy, ox, D), torch)
        nbytes = win_bytes(a, oy, ox, D, 4) + n * 16       # and the origins
        if per_frame:
            add_row(k, ms_k, plain, dev_k, nbytes, 0, lib)
        print(f"[3] K2 {what} N={n} D={D} {path_dtype}: bit-identical (f32 "
              f"and bool; int64 and int32 origins, strided and contiguous); "
              f"kernel {ms_k:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms (CUDA events); device: kernel {fmt_us(dev_k)}, "
              f"library {fmt_us(dev_l)} ({n_l:.0f} kernels); "
              f"{bound_text(nbytes, 0)}; launches a frame {per_frame}, a "
              f"keyframe {per_kf}  [{card}]")

    # The ZMSSD search: image window D and corner-mask window M of the same
    # points in one launch, the mask 4 px (half a patch) further in.
    pairs = [(128, 40, 33, "coarse search", 1, 0),
             (1024, 30, 23, "fine search", 1, 0),
             (2048, 16, 9, "re-find search", 0, 1),
             (512, 29, 21, "trail search (2 a trail-tracking frame)", 0, 0)]
    for n, D, M, what, per_frame, per_kf in pairs:
        oy, ox = origins(frame_atlas, n, D)
        oy.clamp_(0, Ha - D)
        ox.clamp_(0, Wa - D)
        for o in forms(oy, ox):
            got = kgather.gather_window_pair(frame_atlas, frame_mask, *o, D,
                                             4, M)
            ref = kgather.gather_window_pair_plain(frame_atlas, frame_mask,
                                                   *o, D, 4, M)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"K2 pair differs from its plain version: {what} "
                  f"{o[0].dtype} {o[0].stride()}")
        lib_img = library(frame_atlas, oy, ox, D)
        lib_msk = library(frame_mask, oy + 4, ox + 4, M)
        check(torch.equal(lib_img(None), got[0])
              and torch.equal(lib_msk(None), got[1]),
              f"the library calls differ from the K2 pair: {what}")
        pair = (lambda _: kgather.gather_window_pair(
            frame_atlas, frame_mask, oy, ox, D, 4, M))
        ms_k = time_ms(pair, torch)
        plain = time_ms(lambda _: kgather.gather_window_pair_plain(
            frame_atlas, frame_mask, oy, ox, D, 4, M), torch)
        lib = time_ms(lambda _: (lib_img(None), lib_msk(None)), torch)
        dev_k, n_k = device_us(pair, torch, match="gather_")
        dev_l, n_l = device_us(lambda _: (lib_img(None), lib_msk(None)),
                               torch)
        nbytes = (win_bytes(frame_atlas, oy, ox, D, 4)
                  + win_bytes(frame_mask, oy + 4, ox + 4, M, 1) + n * 16)
        if per_frame:
            add_row(k, ms_k, plain, dev_k, nbytes, 0, lib)
        print(f"[3] K2 pair {what} N={n} D={D} f32 + M={M} bool: "
              f"bit-identical (int64 and int32 origins, strided and "
              f"contiguous); one launch ({n_k:.0f} kernels a call); kernel "
              f"{ms_k:.4f} ms, plain {plain:.4f} ms, library (two calls) "
              f"{lib:.4f} ms (CUDA events); device: kernel {fmt_us(dev_k)}, "
              f"library {fmt_us(dev_l)} ({n_l:.0f} kernels); "
              f"{bound_text(nbytes, 0)}; launches a frame {per_frame}, a "
              f"keyframe {per_kf}  [{card}]")
    for k in (kernels[name] for name in KERNELS[:3]):
        print(f"[3] {k['name']} summed over a tracked frame's calls: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']} ms (CUDA events); device "
              f"{fmt_us(k['device_us'])}; bound {k['bound_us']:.3f} us "
              f"({k['bound_by']}); {k['launches_per_frame']} launches a "
              f"frame, {k['launches_per_keyframe']} a keyframe"
              if k["launches_per_frame"] else
              f"[3] {k['name']} summed over a keyframe's calls: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms (CUDA events);"
              f" device {fmt_us(k['device_us'])}; bound {k['bound_us']:.3f} us"
              f" ({k['bound_by']}); {k['launches_per_keyframe']} launches a "
              f"keyframe")

    # ---- 4. tracking ----
    t0 = time.perf_counter()
    m, ff0 = synth.planar_map_scene(seq, max_points=2048, per_level=512,
                                    max_kfs=4)
    n_points = int(m.point_valid.sum())
    frames = [seq.frame(i) for i in range(1, N_FRAMES + 1)]
    cam_params = torch.tensor(REF_PARAMS, device=dev)
    torch.cuda.synchronize()
    print(f"[4] map: {n_points} points, 4 KF slots; scene built in "
          f"{time.perf_counter() - t0:.2f} s")
    check(1500 <= n_points <= 2048, f"map has {n_points} points")

    def step(state, mp, im, prev, **kw):
        return tracker.track_frame_from_image(state, mp, im, prev, seq.cam,
                                              SIZE, cam_params, **kw)

    def pose_errors(st, i):
        gt = seq.pose(i)
        rel = se3.mul(st.pose, se3.inv(gt))
        r_err = float(torch.linalg.vector_norm(se3.so3_log(rel.R)))
        c_err = float(torch.linalg.vector_norm(
            (-st.pose.R.T @ st.pose.t) - (-gt.R.T @ gt.t)))
        return c_err, r_err

    def off_bars(st, i):
        c_err, r_err = pose_errors(st, i)
        if (int(st.quality) != tracker.QUALITY_GOOD or c_err >= 0.02
                or r_err >= 0.01):
            return (i, int(st.quality), c_err, r_err)
        return None

    step(tracker.init_tracker_state(seq.pose(0)), m, frames[0],
         ff0.sbi_track)
    torch.cuda.synchronize()

    state = tracker.init_tracker_state(seq.pose(0), seed=0)
    prev = ff0.sbi_track
    results, step_s = [], []
    reset_launch_counts()
    for im in frames:
        t1 = time.perf_counter()
        out = step(state, m, im, prev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        state, prev = out.state, out.sbi_track
        results.append(out)
    launches = launch_counts()
    for name, n in launches.items():
        kernels[name]["launches"] += n
    # Per frame: FAST over the atlas; for each of the coarse and fine
    # stages the templates and the search pair (image + mask windows).
    expected = {name: k["launches_per_frame"] * N_FRAMES
                for name, k in kernels.items()}
    print(f"[4] launches {launches}, expected {expected}")
    check(launches == expected, "kernel launch counts differ")

    found, attempted, coarse, bad = [], [], 0, []
    worst_c, worst_r = 0.0, 0.0
    for i, out in enumerate(results, start=1):
        res = out.result
        c_err, r_err = pose_errors(out.state, i)
        worst_c, worst_r = max(worst_c, c_err), max(worst_r, r_err)
        found.append(int(res.found.sum()))
        attempted.append(int(res.attempted.sum()))
        coarse += int(res.did_coarse)
        if off_bars(out.state, i):
            bad.append(off_bars(out.state, i))
    med = statistics.median(step_s)
    print(f"[4] found/attempted per frame: min {min(found)}/"
          f"{attempted[found.index(min(found))]}, median "
          f"{statistics.median(found)}/{statistics.median(attempted)}, max "
          f"{max(found)}/{attempted[found.index(max(found))]}; coarse stage "
          f"ran on {coarse}/{N_FRAMES} frames; worst centre error "
          f"{worst_c:.2e}, worst rotation error {worst_r:.2e} rad")
    print(f"[4] step median {med * 1e3:.3f} ms ({1.0 / med:.1f} FPS), min "
          f"{min(step_s) * 1e3:.3f} ms, max {max(step_s) * 1e3:.3f} ms over "
          f"{N_FRAMES} frames, 640x480, {n_points} points  [{card}]")
    check(not bad, f"frames off the bars (frame, quality, centre, rot): {bad}")

    def host_syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            fn()
            torch.cuda.set_sync_debug_mode("default")
        return sorted({f"{w.filename}:{w.lineno}" for w in caught
                       if "called a synchronizing" in str(w.message)})

    syncs = host_syncs(lambda: step(state, m, frames[-1], prev))
    print(f"[4] host syncs in one step: {len(syncs)} {syncs}")

    # ---- 2d. K4 and K5 against their plain versions on phase 4's frames ----
    # Phase 4 again, each frame's start velocity above the coarse gate (as
    # phase 5's), so that the coarse call has found points.
    def rerun_phase4():
        st, pv = tracker.init_tracker_state(seq.pose(0), seed=0), ff0.sbi_track
        for im in frames:
            st = dataclasses.replace(
                st, msd_vel=torch.full((), 0.01, device=dev))
            out = step(st, m, im, pv)
            st, pv = out.state, out.sbi_track
    pose_kernels_phase(torch, dev, card, kernels, add_row, bound_text,
                       rerun_phase4)

    # ---- 5. card against CPU ----
    gen = torch.Generator().manual_seed(11)
    P = m.point_pos.shape[0]
    rc, rf = torch.rand(P, generator=gen), torch.rand(P, generator=gen)
    # A start velocity above the coarse gate, so both stages run.
    start = dataclasses.replace(tracker.init_tracker_state(seq.pose(0)),
                                msd_vel=torch.tensor(0.01, device=dev))
    gpu = step(start, m, frames[0], ff0.sbi_track, rand_coarse=rc.to(dev),
               rand_fine=rf.to(dev)).result
    cpu_state = to_device(start, "cpu")
    cpu_state.generator = torch.Generator()
    cpu_cam = to_device(seq.cam, "cpu")
    t1 = time.perf_counter()
    cpu = tracker.track_frame_from_image(
        cpu_state, to_device(m, "cpu"), frames[0].cpu(),
        to_device(ff0.sbi_track, "cpu"), cpu_cam, SIZE,
        cam_params.cpu(), rand_coarse=rc, rand_fine=rf).result
    cpu_s = time.perf_counter() - t1
    diffs = parity.found_set_differences(
        cpu.meas_point.numpy(), cpu.meas_valid.numpy(), cpu.meas_pos.numpy(),
        gpu, pos_tol=1e-3)
    n_found = int(cpu.meas_valid.sum())
    for d in diffs:
        print(f"[5] difference: {d}")
    d_R = float((gpu.pose.R.cpu() - cpu.pose.R).abs().max())
    d_t = float((gpu.pose.t.cpu() - cpu.pose.t).abs().max())
    check(bool(gpu.did_coarse) and bool(cpu.did_coarse),
          "the coarse stage did not run")
    print(f"[5] card vs CPU on frame 1: found {int(gpu.meas_valid.sum())} vs "
          f"{n_found}, {len(diffs)} differences, pose |dR| {d_R:.2e} "
          f"|dt| {d_t:.2e}; CPU step {cpu_s:.2f} s")
    check(all(d["reason"] for d in diffs), "unexplained found-set difference")
    check(len(diffs) < 0.01 * n_found, "too many found-set differences")
    check(d_R <= POSE_TOL and d_t <= POSE_TOL, "card and CPU poses differ")

    # ---- 6. the keyframe path ----
    mm_cfg = MapMakerConfig()
    t0 = time.perf_counter()
    mk, ffk0 = synth.candidate_map_scene(seq, max_points=2048, max_kfs=4,
                                         candidate_min_score=CAND_MIN)
    n_points = int(mk.point_valid.sum())
    P = mk.point_pos.shape[0]
    torch.cuda.synchronize()
    print(f"[6] map: {n_points} points from frame 0's candidates per level "
          f"{ffk0.cand_valid.sum(-1).tolist()}, {P} slots, 4 KF slots; "
          f"built in {time.perf_counter() - t0:.2f} s")
    check(1000 <= n_points < P, f"map has {n_points} points")

    def integrate(mp, ff, pose, res, diag=None):
        return mapmaker.integrate_keyframe_program(
            mp, ff, pose, res.meas_point, res.meas_pos, res.meas_level,
            res.meas_subpix, res.meas_valid, res.depth_mean, res.depth_sigma,
            torch.zeros(P, dtype=torch.bool, device=mp.point_pos.device),
            seq.cam if mp.point_pos.is_cuda else cpu_cam, SIZE,
            mm_cfg.wiggle_scale, mm_cfg.thin_candidates_radius, diag=diag)

    state = tracker.init_tracker_state(seq.pose(0), seed=1)
    prev = ffk0.sbi_track
    bad = []
    reset_launch_counts()
    for i in range(1, N_TRACK_KF + 1):
        out = step(state, mk, frames[i - 1], prev)
        state, prev = out.state, out.sbi_track
        bad += [b for b in [off_bars(state, i)] if b]
    res_kf, state_kf, prev_kf = out.result, state, prev
    check(not bad, f"frames 1..{N_TRACK_KF} off the bars: {bad}")
    need = bool(mapmaker.need_new_kf(mk, state_kf.pose, state_kf.depth_mean,
                                     1.0, mm_cfg.max_kf_dist_wiggle_mult))
    print(f"[6] frames 1..{N_TRACK_KF} GOOD; need_new_kf at frame "
          f"{N_TRACK_KF}: {need} (wiggle_depth_norm 1.0); integrating "
          f"anyway, as bench_mapping.py does")

    before = launch_counts()
    im_kf = frames[N_TRACK_KF - 1]
    ff = kflib.build_frame(im_kf, candidate_min_score=CAND_MIN)
    m_before = ms.copy_map(mk)
    with k6_recorder(torch) as k6_calls:
        mk2, new_mask, slot_n = integrate(mk, ff, state_kf.pose, res_kf)
    slot, n_added = slot_n.tolist()
    kf_launches = {n: c - before[n] for n, c in launch_counts().items()}
    # build_frame: FAST and Shi-Tomasi over the atlas. Integration:
    # the re-find gathers templates and the search pair; each of the 4
    # epipolar levels templates, corner patches and sub-pixel windows.
    kf_expected = {name: k["launches_per_keyframe"]
                   for name, k in kernels.items()}
    new_idx = torch.nonzero(new_mask)[:, 0]
    per_level = {lev: int((mk2.point_src_level[new_idx] == lev).sum())
                 for lev in mapmaker.EPI_LEVEL_ORDER}
    refound = int((mk2.meas_valid[slot]
                   & (mk2.meas_source[slot] == ms.SRC_REFIND)).sum())
    z = mk2.point_pos[new_idx, 2].abs()
    print(f"[6] frame {N_TRACK_KF}: candidates per level "
          f"{ff.cand_valid.sum(-1).tolist()}; keyframe slot {slot}; "
          f"{int(res_kf.meas_valid.sum())} tracker measurements; "
          f"re-found {refound}; added {n_added} points, per level "
          f"{per_level}; launches of build + integration {kf_launches}, "
          f"expected {kf_expected}")
    check(kf_launches == kf_expected, "keyframe-path launch counts differ")
    check(n_added > 0 and n_added == len(new_idx), "no points were added")
    med_z = float(z.median())
    print(f"[6] new points' world |z|: median {med_z:.2e}, 90th percentile "
          f"{float(torch.quantile(z, 0.9)):.2e}, max {float(z.max()):.2e} "
          f"(the scene is the z=0 plane at depth 1.5)")
    check(med_z < 0.02, f"new points off the plane: median |z| {med_z}")

    new_found, bad = 0, []
    for i in range(N_TRACK_KF + 1, N_FRAMES + 1):
        out = step(state, mk2, frames[i - 1], prev)
        state, prev = out.state, out.sbi_track
        bad += [b for b in [off_bars(state, i)] if b]
        r = out.result
        new_found += int((r.meas_valid & new_mask[r.meas_point]).sum())
    launches = launch_counts()
    for name, n in launches.items():
        kernels[name]["launches"] += n
    expected = {name: k["launches_per_frame"] * N_FRAMES
                + k["launches_per_keyframe"] for name, k in kernels.items()}
    print(f"[6] frames {N_TRACK_KF + 1}..{N_FRAMES} against the grown map: "
          f"{new_found} measurements of new points found; off the bars: "
          f"{bad}; launches of the phase {launches}, expected {expected}")
    check(not bad, "frames off the bars after the keyframe")
    check(new_found > 0, "no new point was found after the keyframe")
    check(launches == expected, "phase-6 launch counts differ")
    # K6's calls in the integration (compared after the count): the
    # re-find's 16x16 windows, then the epipolar levels' gathered 15x15.
    k6_d = [a[3].shape[-1] for a in k6_calls]
    check(k6_d == [16, 15, 15, 15, 15], f"6: K6's calls in the "
          f"integration, by window side: {k6_d}")
    if k6_d == [16, 15, 15, 15, 15]:
        k6_against_plain(torch, k6_calls[:1], "6", "re-find", card)
        k6_against_plain(torch, k6_calls[1:], "6", "epipolar", card)

    build_ms = time_ms(lambda _: kflib.build_frame(
        im_kf, candidate_min_score=CAND_MIN), torch)
    int_ms = time_ms(lambda mp: integrate(mp, ff, state_kf.pose, res_kf),
                     torch, reps=INT_REPS,
                     setup=lambda: ms.copy_map(m_before))
    int_host = []
    for _ in range(INT_REPS):
        mp = ms.copy_map(m_before)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        integrate(mp, ff, state_kf.pose, res_kf)
        torch.cuda.synchronize()
        int_host.append(time.perf_counter() - t1)
    mp = ms.copy_map(m_before)
    syncs = host_syncs(lambda: integrate(mp, ff, state_kf.pose, res_kf))
    print(f"[6] host syncs in one integration: {len(syncs)} {syncs}")
    b_dev, b_n = device_us(lambda _: kflib.build_frame(
        im_kf, candidate_min_score=CAND_MIN), torch, n=5)
    i_dev, i_n = device_us(lambda mp: integrate(mp, ff, state_kf.pose, res_kf),
                           torch, n=3, setup=lambda: ms.copy_map(m_before))
    print(f"[6] build_frame 640x480: {build_ms:.3f} ms (CUDA events), device "
          f"{fmt_us(b_dev)} in {b_n:.0f} kernels; integration of {n_points} "
          f"points: {int_ms:.3f} ms (CUDA events), host "
          f"{statistics.median(int_host) * 1e3:.3f} ms, device "
          f"{fmt_us(i_dev)} in {i_n:.0f} kernels  [{card}]")

    ph6 = dict(m=ms.copy_map(m_before), ff=ff, pose=state_kf.pose,
               res=res_kf, cam=seq.cam)

    # ---- 7. card against CPU for the integration ----
    t1 = time.perf_counter()
    cpu_m, _, cpu_sn = integrate(
        ms.copy_map(to_device(m_before, "cpu")), to_device(ff, "cpu"),
        to_device(state_kf.pose, "cpu"), to_device(res_kf, "cpu"))
    cpu_s = time.perf_counter() - t1
    diag = {}
    gpu_m, _, gpu_sn = integrate(ms.copy_map(m_before), ff, state_kf.pose,
                                 res_kf, diag=diag)
    fields = ("point_valid", "point_src_level", "point_center", "point_pos",
              "meas_valid", "meas_pos", "meas_source")
    diffs, n7 = parity.integration_differences(
        {f: getattr(cpu_m, f) for f in fields},
        {f: getattr(gpu_m, f) for f in fields}, m_before.point_valid,
        int(cpu_sn[0]), diag, mm_cfg.thin_candidates_radius, POS_TOL)
    for d in diffs:
        print(f"[7] difference: {d}")
    n_cmp = n7["refound"] + sum(n7["added"].values())
    print(f"[7] card vs CPU integration: slot {int(gpu_sn[0])} vs "
          f"{int(cpu_sn[0])}, added {int(gpu_sn[1])} vs {int(cpu_sn[1])} "
          f"(CPU per level {n7['added']}), re-found by the CPU "
          f"{n7['refound']}; {len(diffs)} differences; CPU integration "
          f"{cpu_s:.2f} s")
    check(int(gpu_sn[0]) == int(cpu_sn[0]), "card and CPU slots differ")
    check(all(d["reason"] for d in diffs),
          "unexplained integration difference")
    check(len(diffs) <= 0.01 * n_cmp, "too many integration differences")

    # ---- 8. bundle adjustment ----
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    reset_launch_counts()
    for tier, shape in BA_TIERS.items():
        ba_tier(torch, dev, card, tier, *shape)

    # ---- 9. the MapMaker's BA ----
    ba_mapmaker_64(torch, dev, card)
    gpu_m6 = ba_mapmaker_phase6(torch, card, mk2, new_mask, seq.cam, cpu_cam)
    launches = launch_counts()
    print(f"[9] launches of K1-K6 in phases 8-9's BA: {launches} (BA has "
          f"no hand-written kernel)")
    check(not any(launches.values()), "BA launched a kernel of K1-K6")
    bad, state, prev = [], state_kf, prev_kf
    reset_launch_counts()
    for i in range(N_TRACK_KF + 1, N_FRAMES + 1):
        out = step(state, gpu_m6, frames[i - 1], prev)
        state, prev = out.state, out.sbi_track
        bad += [b for b in [off_bars(state, i)] if b]
    launches = launch_counts()
    expected = {name: k["launches_per_frame"] * (N_FRAMES - N_TRACK_KF)
                for name, k in kernels.items()}
    print(f"[9] frames {N_TRACK_KF + 1}..{N_FRAMES} against the adjusted "
          f"map: off the bars {bad}; launches {launches}, expected "
          f"{expected}")
    check(not bad, "frames off the bars after BA")
    check(launches == expected, "phase-9 tracking launch counts differ")

    # ---- 10. the bootstrap path: trails, stereo init, relocalization ----
    bootstrap(torch, dev, card, kernels, reset_launch_counts, launch_counts)

    # ---- 11. the engine: process_frame end to end ----
    ph11 = engine(torch, dev, card, kernels, reset_launch_counts,
                  launch_counts)

    # ---- 12. the engine with its mapping worker ----
    async_engine(torch, dev, card, kernels, reset_launch_counts,
                 launch_counts, mods, ph11)

    # ---- 13. the dataset entry point ----
    dataset_entry(torch, card, ph11)

    # ---- 14. point-sharded global BA over torch.distributed ----
    sharded_ba_phase(torch, dev, card)

    # ---- 15. the engine with a 2-rank mesh ----
    meshed_engine(torch, dev, card, kernels, ph11)

    # ---- 16. the calibrator and the nonplanar scene ----
    calibration_and_scene(torch, dev, card)

    # ---- 17. the engine's programs as CUDA graphs ----
    programs_phase(torch, dev, card, mods, seq, m, ff0, frames,
                   frames[N_TRACK_KF - 1], ph11)

    # ---- 18. the MapMaker's programs and BA's chunk as CUDA graphs ----
    map_programs_phase(torch, dev, card, mods, kernels, ph6, ph11)

    # ---- 19. the bf16 frontend configuration ----
    bf16_phase(torch, dev, card, kernels, entry, add_row, bound_text,
               reset_launch_counts, launch_counts, ph11)

    check(not any(k == "jax" or k.startswith("jax.") for k in sys.modules),
          "jax was imported")
    print(f"[end] the whole script: {time.perf_counter() - t_script:.1f} s "
          f"[{card}]")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(sys.argv[1:])
    else:
        main()
