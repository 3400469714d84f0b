"""Run the PyTorch port's tracking step, keyframe integration and bundle
adjustment on one NVIDIA GPU.

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
   windows in one launch) at the three search shapes: bit-identical.
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
   product against its bound;
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
   pruned, printed.
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
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0 and (match is None or match in e.key):
                total += t
                count += e.count
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
    #  launches a frame, a keyframe)
    singles = [(kf_atlases, 128, 28, "coarse templates", "f32", 1, 0),
               (kf_atlases, 1024, 28, "fine templates", "f32", 1, 0),
               (kf_atlases, 2048, 28, "re-find templates", "f32", 0, 1),
               (kf_atlases, 512, 28, "epipolar templates", "f32", 0, 4),
               (frame_atlas, 2048, 8, "epipolar corner patches", "f32", 0, 4),
               (frame_atlas, 512, 15, "sub-pixel window", "f32", 0, 4)]
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
             (2048, 16, 9, "re-find search", 0, 1)]
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

    check(not any(k == "jax" or k.startswith("jax.") for k in sys.modules),
          "jax was imported")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
