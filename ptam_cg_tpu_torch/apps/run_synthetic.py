"""Run the port's SLAM engine on a synthetic sequence with ground truth and
print the ATE: the port's counterpart of ``examples/run_synthetic.py``.

    python -m ptam_cg_tpu_torch.apps.run_synthetic [--frames N]
        [--size WxH] [--seed S] [--async-mapping] [--ar OUT_DIR]
        [--profile DIR] [--device cuda|cpu]

The sequence is tests/test_slam_e2e.py's orbit (height 1.5, radius 0.35,
sweep 1.3 over the frames) rendered by the port's own synth on the
engine's device. ``--profile DIR`` records frames n/2 .. n/2 + 2 with
``torch.profiler`` (the host and, on the card, CUDA activity) and writes
a Chrome trace to ``DIR/trace.json``. ``main(argv)`` returns a summary
(see ``main``); it exits with status 1 when tracking never starts.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ptam_cg_tpu_torch.apps.run_tum import ar_renderer

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ptam_cg_tpu_torch.apps.run_synthetic")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--async-mapping", action="store_true",
                    help="run the mapping passes on a worker thread")
    ap.add_argument("--ar", default=None, metavar="OUT_DIR",
                    help="write AR composites (EyeGame's eyeballs) of the "
                         "tracked frames as PPMs")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of three frames "
                         "from the middle of the run to DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default: the card)")
    return ap.parse_args(argv)


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, out_dir):
    """Stop ``prof`` and write its Chrome trace; returns None."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace -> {path}")
    return None


def main(argv=None) -> dict:
    """Run the sequence. Returns {"infos", "times", "ate", "span",
    "engine"} as ``run_tum.main`` does."""
    args = parse_args(argv)
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          MapMakerConfig)
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.models import engine as engine_lib
    from ptam_cg_tpu_torch.utils import evaluate

    size = tuple(int(x) for x in args.size.split("x"))
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=size,
                                  n_frames=args.frames, seed=args.seed,
                                  height=1.5, radius=0.35, sweep=1.3,
                                  device=args.device)
    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=size),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=70.0))
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=2048,
                                max_kfs=12, auto_init_frames=6,
                                seed=args.seed,
                                async_mapping=args.async_mapping,
                                device=args.device)
    render_ar = ar_renderer(eng, size, args.ar) if args.ar else None
    est, gt, times, infos = [], [], [], []
    prof = None
    try:
        for i in range(args.frames):
            if args.profile and i == args.frames // 2:
                prof = _start_profile(args.device)
            frame = seq.frame(i)
            t0 = time.perf_counter()
            info = eng.process_frame(frame)
            times.append(time.perf_counter() - t0)
            infos.append(info)
            if prof is not None and i == args.frames // 2 + 2:
                prof = _stop_profile(prof, args.profile)
            print(f"frame {i:3d} [{info.stage:14s}] q={info.quality} "
                  f"found={info.n_found:4d} pts={info.n_points:4d} "
                  f"kfs={info.n_kfs} {'KF+' if info.added_kf else ''} "
                  f"{'RELOC' if info.relocalized else ''} "
                  f"({times[-1] * 1000:.0f} ms)")
            if info.stage == "TRACKING":
                est.append((-info.pose.R.T @ info.pose.t).cpu().numpy())
                c = seq.pose(i)
                gt.append((-c.R.T @ c.t).cpu().numpy())
                if render_ar is not None:
                    render_ar(frame, info.pose, i)
    finally:
        if prof is not None:
            _stop_profile(prof, args.profile)
        eng.close()
    if len(est) <= 5:
        print("\nFAILED: tracking never started")
        sys.exit(1)
    g = np.stack(gt)
    ate = evaluate.ate_rmse(np.stack(est), g)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    print(f"\nATE RMSE: {ate * 1000:.1f} mm over a {span:.2f} m "
          f"trajectory ({len(est)} tracked frames)")
    print(f"median frame time: {np.median(times) * 1000:.0f} ms")
    return dict(infos=infos, times=times, ate=ate, span=span, engine=eng)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main()
