"""Run the PyTorch port's tracking step, keyframe integration, bundle
adjustment, stereo init and relocalization on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; build the three CUDA kernels
   (``ptam_cg_tpu_torch/csrc``) and phase 2c's variants of K3 with nvcc
   for sm_90a, one nvcc each, all at once;
2. K1 (FAST-10) against its plain PyTorch version over the pyramid atlas
   of a 640x480 frame, in one launch: mask atlas, scores and per-level
   counts bit-identical, with and without the scores;
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
   must equal the calls the step makes times 60 (1 K1 and 4 K2 a frame);
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
   (the keyframe: 1 K1, 1 K3 and 14 K2).
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
The line before the last is a JSON summary of the kernels (numbers summed
over a tracked frame's calls, K3's over a keyframe's); the last line is
the JSON result. Times are medians of CUDA-event timings.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
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
KERNELS = ("fast10", "gather_windows", "shi_tomasi")
# Phase 2c: K3's tile shapes (output columns x rows a block, pixels a
# thread along x); () is the default build, the keyframe path's.
ST_VARIANTS = ((), ("ST_TILE_H=32",), ("ST_PX=1",),
               ("ST_TILE_W=32", "ST_PX=1"), ("ST_TILE_W=128", "ST_PX=4"))
HOST_CALLS = 200
# The bound of a kernel call: H100 SXM HBM rate and float32 peak outside
# the tensor cores (NVIDIA's data sheet, at 700 W); one add, subtract,
# compare, min, max, multiply, divide or root counts as one operation.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# K3's float32 operations a pixel: 2 gradients, 3 products, 3 x (6 + 6)
# box-sum adds, 3 divides, 11 for the smaller eigenvalue.
SHI_OPS = 55
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
ENG_PROFILE = 20     # 11c: the last frames, under the profiler
ENG_SYNC = 10        # 11c: the frames before them, under sync debug mode
ENG_CPU1 = 16        # 11b: frames the CPU runs on one thread (the spread)
# 11b: card against CPU, each frame's rotation and translation over |t|
# on the init frame (the scale is free): ~3x the larger of the measured
# card-vs-CPU and 1-vs-8-thread spreads (|dR| 2.55e-5 and 9.80e-6, |dt|
# 1.51e-6 and 5.03e-7 on one H100, PERF.md §6).
ENG_ROT_TOL = 8e-5
ENG_T_TOL = 5e-6


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
    per_trail = {"fast10": 1, "shi_tomasi": 1, "gather_windows": 3}
    want = {name: 1 + N_TRAIL * n for name, n in per_trail.items()}
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
    pose2 = initializer.init_from_stereo(
        mk, ffs[0], ffs[-1], trails[-1], u_mlesac.to(dev), u_plane.to(dev),
        icfg, stats=stats)
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
    # epipolar level templates, corner patches and sub-pixel windows.
    want_init = {"fast10": 0, "shi_tomasi": 0, "gather_windows": 2 + 3 * 4}
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

    def track(self, n):
        return tuple(u.to(self.device) for u in self.base.track(n))

    def mlesac(self, trials, n):
        return self.base.mlesac(trials, n).to(self.device)

    def plane(self, n_ransacs, n):
        return self.base.plane(n_ransacs, n).to(self.device)


class CallCounts:
    """Counts the calls of module functions while active (each patched
    with a counting wrapper, restored on exit)."""

    def __init__(self, targets):
        self.targets, self.n = targets, {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


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
          f"{span:.4f} ({ate / max(span, 0.1) * 100:.3f}%)")
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


def engine(torch, dev, card, kernels, reset_counts, counts):
    """Phase 11: ``SLAMEngine.process_frame`` on bench_engine.py's scene,
    deterministic (11a), card against CPU (11b), the card's latency mode
    (11c), relocalization and reset (11d); then a faster orbit on which
    integrations add points, card against CPU (11e)."""
    import numpy as np
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import engine as englib
    from ptam_cg_tpu_torch.models import initializer, keyframe, mapmaker
    from ptam_cg_tpu_torch.models import tracker

    W, H = SIZE
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                  **ENG_SEQ)
    frames = [seq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
              for i in range(ENG_SEQ["n_frames"])]

    def make(device, cand_min=ENG_CAND_MIN, capacity=ENG_MAP, **kw):
        cfg = EngineConfig(
            camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
            mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=cand_min))
        return englib.SLAMEngine(cfg, image_size=SIZE, device=device,
                                 **capacity, **kw)

    # What launches each kernel on the engine's path: K1 in every build,
    # K3 in a keyframe build; K2 4 a tracked frame, 2 a re-find of one
    # keyframe, 3 an epipolar level, 1 at the trail start, 3 a trail
    # frame, 2 in an init outside its epipolar levels.
    targets = [(tracker, "track_frame_from_image"), (keyframe, "build_frame"),
               (mapmaker, "refind_in_kf"), (mapmaker, "add_points_epipolar"),
               (initializer, "trail_start"), (initializer, "trail_advance"),
               (initializer, "init_from_stereo")]

    def expected(n):
        return {"fast10": n["track_frame_from_image"] + n["build_frame"],
                "shi_tomasi": n["build_frame"],
                "gather_windows": 4 * n["track_frame_from_image"]
                + 2 * n["refind_in_kf"] + 3 * n["add_points_epipolar"]
                + n["trail_start"] + 3 * n["trail_advance"]
                + 2 * n["init_from_stereo"]}

    def run(eng, ims, times=None):
        """Each frame's FrameInfo; ``times`` gets each ``process_frame``'s
        return time on the host clock (no sync, as bench_engine.py)."""
        infos = []
        for im in ims:
            t0 = time.perf_counter()
            infos.append(eng.process_frame(im))
            if times is not None:
                times.append(time.perf_counter() - t0)
        return infos

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
    bad, d_R, d_t = engine_diffs(card_a[:n_b], cpu_runs["cpu"], first, torch)
    _, t_R, t_t = engine_diffs(cpu_runs["cpu1"], cpu_runs["cpu"][:ENG_CPU1],
                               first, torch)
    print(f"[11b] card vs CPU over frames 0..{n_b - 1} ({n_b - first} "
          f"tracked, {card_a[n_b - 1].n_kfs} keyframes): outcome differences "
          f"{bad}; |dR| {d_R:.2e}, |dt| / |t| {d_t:.2e}; CPU 1 vs "
          f"{n_threads} threads over frames 0..{ENG_CPU1 - 1}: |dR| "
          f"{t_R:.2e}, |dt| / |t| {t_t:.2e}; CPU {cpu_runs['cpu s']:.1f} s, "
          f"1 thread {cpu_runs['cpu1 s']:.1f} s")
    check(not bad, "11b: card and CPU engines differ in outcome")
    check(d_R <= ENG_ROT_TOL and d_t <= ENG_T_TOL,
          "11b: card and CPU engine poses differ")

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
    tracked = [(k, times[k]) for k, i in enumerate(lat[:n_main])
               if i.stage == "TRACKING"]
    kf_frames = [(k, round(t * 1e3, 1)) for k, t in tracked
                 if lat[k].added_kf]
    steady = sorted(t * 1e3 for k, t in tracked if not lat[k].added_kf)
    pct = lambda q: steady[min(len(steady) - 1, int(q * len(steady)))]  # noqa
    print(f"[11c] latency mode, frames 0..{n_main - 1}: tracked-frame latency "
          f"(host clock, process_frame's return, no sync) p50 "
          f"{pct(0.5):.1f} ms, p95 {pct(0.95):.1f} ms, max "
          f"{steady[-1]:.1f} ms over {len(steady)} frames; keyframe frames "
          f"(frame, ms) {kf_frames}; {n_main / wall:.2f} FPS over all "
          f"{n_main} frames ({wall:.1f} s, one sync at the end); mapping "
          f"passes that found the card busy {busy} of {passes}  [{card}]")
    print(f"[11c] host reads a tracked frame (sync debug mode), frames "
          f"{n_main}..{n_main + ENG_SYNC - 1}: {[len(x) for x in syncs]}; "
          f"where: {sorted(set(sum(syncs, [])))}")
    print(f"[11c] device busy share over frames {n_main + ENG_SYNC}.."
          f"{len(frames) - 1} (profiler): {busy_us / 1e3:.1f} ms of device "
          f"time in {prof_wall * 1e3:.1f} ms, "
          f"{busy_us / 1e6 / prof_wall * 100:.1f}% busy; launches {launches}"
          f"  [{card}]")
    engine_outcome(lat, seq, torch, "11c")

    # ---- 11d. relocalization and reset (tests/test_engine_reloc.py) ----
    rseq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                   **RELOC_SEQ)
    rframes = [rseq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
               for i in range(RELOC_SEQ["n_frames"])]
    eng = make(dev, cand_min=INIT_CAND_MIN, capacity=dict(
        INIT_MAP, auto_init_frames=6, seed=0), deterministic=True)
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
    eng = make(dev, cand_min=INIT_CAND_MIN, capacity=dict(
        INIT_MAP, auto_init_frames=6, seed=0), deterministic=True)
    info = run(eng, rframes[:10])[-1]
    check(info.stage == "TRACKING", "11d: no init on the reset run")
    m = eng.map
    eng.map = eng.mapmaker.map = dataclasses.replace(m, meas_pos=torch.where(
        m.meas_valid[..., None], torch.tensor(3e19, device=dev),
        m.meas_pos))
    eng.mapmaker.converged_recent, eng.mapmaker.converged_full = True, False
    after = []
    for im in rframes[10:]:
        after.append(eng.process_frame(im))
        if after[-1].stage == "NOT_STARTED":
            break
    reset = after[-1]
    again = []
    for im in rframes + rframes:
        again.append(eng.process_frame(im))
        if again[-1].stage == "TRACKING":
            break
    print(f"[11d] poisoned meas_pos: stages after it "
          f"{[i.stage for i in after]} ({reset.n_points} points, "
          f"{reset.n_kfs} keyframes); re-initialized after {len(again)} "
          f"frames: {again[-1].stage}, {again[-1].n_points} points")
    check(reset.stage == "NOT_STARTED" and reset.n_points == 0
          and reset.n_kfs == 0 and not eng.mapmaker.reset_requested,
          "11d: the poisoned map was not ditched")
    check(again[-1].stage == "TRACKING", "11d: no re-init after the reset")

    # ---- 11e. the map grows while the camera tracks: card and CPU ----
    gseq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, device=dev,
                                   **GROW_SEQ)
    gframes = [gseq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
               for i in range(GROW_SEQ["n_frames"])]
    grown, gjobs, secs = {}, {}, {}
    for tag, where, threads in (("card", dev, n_threads),
                                ("CPU", "cpu", n_threads),
                                ("CPU 1 thread", "cpu", 1)):
        torch.set_num_threads(threads)
        eng = make(where, cand_min=INIT_CAND_MIN, deterministic=True,
                   draws=HostDraws(englib, 0, where))
        gjobs[tag] = dict.fromkeys(MAPMAKER_JOBS, 0)
        watch_mapmaker(eng.mapmaker, gjobs[tag])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with CallCounts(targets) as calls:
            grown[tag] = run(eng, gframes)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        if tag == "card":
            launches, want = counts(), expected(calls.n)
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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import numpy as np

    from ptam_cg_tpu_torch.config import FrontendConfig, MapMakerConfig
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import _build
    from ptam_cg_tpu_torch.kernels import fast as kfast
    from ptam_cg_tpu_torch.kernels import gather as kgather
    from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi
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
    mods = {"fast10": kfast, "gather_windows": kgather, "shi_tomasi": kshi}

    def reset_launch_counts():
        for mod in mods.values():
            mod.launches = 0

    def launch_counts():
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
        ("shi_tomasi", v) for v in ST_VARIANTS if v]
    _build.load_all(builds)
    print(f"[1] built and loaded {len(KERNELS)} kernels and "
          f"{len(builds) - len(KERNELS)} variants of K3 in "
          f"{time.perf_counter() - t0:.1f} s")
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
                    launches_per_keyframe=per_keyframe)

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
                            False)}

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
    for k in kernels.values():
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
    print(f"[9] launches of K1-K3 in phases 8-9's BA: {launches} (BA has "
          f"no hand-written kernel)")
    check(not any(launches.values()), "BA launched a kernel of K1-K3")
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
    engine(torch, dev, card, kernels, reset_launch_counts, launch_counts)

    check(not any(k == "jax" or k.startswith("jax.") for k in sys.modules),
          "jax was imported")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
