"""Run the port's SLAM engine on a TUM-RGBD-format dataset directory: the
port's counterpart of ``examples/run_tum.py``, the reference's dataset
mode (VideoSource.DataSet in settings.cfg, src/VideoSource.cc:59-159).
Prints a line every 10 frames and on keyframes, the ATE against
``groundtruth.txt`` when the dataset has one, and writes the map render,
the AR frames and the checkpoint asked for.

    python -m ptam_cg_tpu_torch.apps.run_tum DATASET_DIR
        [--settings settings.cfg] [--frames N] [--native]
        [--ar OUT_DIR] [--ar-every N] [--map out.ppm]
        [--checkpoint out.npz] [--commands FILE] [--rate HZ]
        [--device cuda|cpu]

The engine runs on the card unless ``--device cpu``. With ``--native``
the C++ frame pump reads the frames (``.npy`` and ``.pgm`` only);
otherwise ``io.tum.TumDataset`` does (PNG and JPG too, with PIL).
``main(argv)`` returns a summary (see ``main``) for callers in process.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ptam_cg_tpu_torch.apps.run_tum")
    ap.add_argument("dataset")
    ap.add_argument("--settings", default=None,
                    help="reference-format settings.cfg")
    ap.add_argument("--frames", type=int, default=0,
                    help="frame cap (0 = the whole dataset)")
    ap.add_argument("--native", action="store_true",
                    help="read frames with the C++ prefetching frame pump")
    ap.add_argument("--ar", default=None, metavar="OUT_DIR",
                    help="write AR composites (EyeGame's eyeballs on the "
                         "dominant plane) as PPMs")
    ap.add_argument("--ar-every", type=int, default=5,
                    help="render every Nth tracked frame with --ar")
    ap.add_argument("--map", default=None,
                    help="write a top-down map render (PPM) at the end")
    ap.add_argument("--checkpoint", default=None,
                    help="write a map checkpoint (npz) at the end")
    ap.add_argument("--commands", default=None, metavar="FILE",
                    help="scripted console commands, one a line, an "
                         "optional @FRAME prefix (io/commands.py)")
    ap.add_argument("--rate", type=float, default=0.0, metavar="HZ",
                    help="pace the replay at HZ frames/s, as the "
                         "reference's 25 FPS dataset sleep "
                         "(src/VideoSource.cc:102-103); 0 = unthrottled")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default: the card)")
    return ap.parse_args(argv)


def ar_renderer(eng, size, out_dir):
    """A function (frame, pose, index) writing the AR composite of a
    tracked frame to ``out_dir/ar_<index>.ppm``."""
    from ptam_cg_tpu_torch.viz import ar as arlib
    from ptam_cg_tpu_torch.viz import mapviewer
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    def render(frame, pose, i):
        verts, tris, shades = arlib.make_eye_game(-pose.R.T @ pose.t)
        out = arlib.render_ar_frame(frame, pose, eng.cam, size, verts, tris,
                                    shades, ufb_size=size)
        gray = np.clip(out.cpu().numpy(), 0, 255)
        mapviewer.save_ppm(str(Path(out_dir) / f"ar_{i:05d}.ppm"),
                           np.repeat(gray[..., None], 3, axis=-1))
    return render


def main(argv=None) -> dict:
    """Run the dataset. Returns {"infos": each frame's FrameInfo,
    "times": each ``process_frame``'s seconds, "console": (frame, message)
    of each console line run, "ate": ATE RMSE or None, "span": the
    ground truth's extent or None, "engine": the engine}."""
    args = parse_args(argv)
    from ptam_cg_tpu_torch.config import EngineConfig
    from ptam_cg_tpu_torch.io import settings as settingslib
    from ptam_cg_tpu_torch.io import tum
    from ptam_cg_tpu_torch.models import engine as engine_lib
    from ptam_cg_tpu_torch.utils import evaluate
    from ptam_cg_tpu_torch.viz import mapviewer

    cfg = (settingslib.load_engine_config(args.settings)[0] if args.settings
           else EngineConfig())
    if args.native:
        from ptam_cg_tpu_torch import native
        ds = native.NativeFramePump(args.dataset, prefetch=4, loop=False)
        frame_iter = iter(ds.next_frame, None)
    else:
        ds = tum.TumDataset(args.dataset, loop=False)
        frame_iter = iter(ds)
    n_frames = len(ds) if not args.frames else min(len(ds), args.frames)
    try:
        ts, frame = next(frame_iter)
    except StopIteration:
        sys.exit("no frames in the dataset")
    size = (frame.shape[1], frame.shape[0])
    eng = engine_lib.SLAMEngine(cfg, image_size=size, max_points=4096,
                                max_kfs=16, auto_init_frames=8,
                                device=args.device)
    gt = None
    if (Path(args.dataset) / "groundtruth.txt").is_file():
        gt = tum.load_groundtruth(args.dataset)
    render_ar = ar_renderer(eng, size, args.ar) if args.ar else None
    console = None
    if args.commands:
        from ptam_cg_tpu_torch.io import commands as cmdlib
        console = cmdlib.ScriptedConsole(
            eng, cmdlib.load_command_script(args.commands))

    infos, times, ran, est, gt_centers, traj = [], [], [], [], [], []
    period = 1.0 / args.rate if args.rate > 0 else 0.0
    next_tick = time.perf_counter()
    try:
        for i in range(n_frames):
            if console is not None:
                for msg in console.on_frame(i):
                    print(f"console @{i}: {msg}")
                    ran.append((i, msg))
            if period:
                now = time.perf_counter()
                if now < next_tick:
                    time.sleep(next_tick - now)
                next_tick = max(next_tick + period, time.perf_counter())
            t0 = time.perf_counter()
            info = eng.process_frame(frame)
            times.append(time.perf_counter() - t0)
            infos.append(info)
            if i % 10 == 0 or info.added_kf:
                print(f"frame {i:4d} [{info.stage:14s}] q={info.quality} "
                      f"found={info.n_found:4d} pts={info.n_points:4d} "
                      f"kfs={info.n_kfs} ({times[-1] * 1000:.0f} ms)")
            if info.stage == "TRACKING":
                c = (-info.pose.R.T @ info.pose.t).cpu().numpy()
                est.append(c)
                traj.append(c)
                if gt is not None:
                    gt_centers.append(gt[1][int(np.argmin(
                        np.abs(gt[0] - ts)))])
                if render_ar is not None and i % args.ar_every == 0:
                    render_ar(frame, info.pose, i)
            if i + 1 < n_frames:
                try:
                    ts, frame = next(frame_iter)
                except StopIteration:
                    break
    finally:
        eng.close()
        if args.native:
            ds.close()

    print(f"\nprocessed {len(times)} frames, median "
          f"{np.median(times) * 1000:.0f} ms/frame")
    ate = span = None
    if gt is not None and len(est) > 10:
        g = np.stack(gt_centers)
        ate = evaluate.ate_rmse(np.stack(est), g)
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        print(f"ATE RMSE vs groundtruth: {ate * 1000:.1f} mm over a "
              f"{span:.3f} m trajectory ({len(est)} tracked frames)")
    final_map = eng.snapshot()
    if args.map:
        mapviewer.save_ppm(args.map, mapviewer.render_topdown(
            final_map, trajectory=np.stack(traj) if traj else None))
        print(f"map render -> {args.map}")
    if args.checkpoint:
        from ptam_cg_tpu_torch.io import checkpoint
        checkpoint.save_map(args.checkpoint, final_map, eng.tracker_state)
        print(f"checkpoint -> {args.checkpoint}")
    return dict(infos=infos, times=times, console=ran, ate=ate, span=span,
                engine=eng)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main()
