"""Camera calibration, the reference's second executable: the port's
counterpart of ``examples/run_calib.py`` (src/CameraCalibrator.cc:31-146:
grab checkerboard views, grow a grid in each, optimize the N poses and
the 5 ATAN parameters jointly, save ``Camera.Parameters``).

    python -m ptam_cg_tpu_torch.apps.run_calib IMAGE_DIR [--out camera.cfg]
    python -m ptam_cg_tpu_torch.apps.run_calib --synthetic 5
        [--size WxH] [--iters N] [--out camera.cfg] [--device cuda|cpu]

Views come from a directory of grayscale ``.pgm`` / ``.png`` / ``.npy``
files, or from the synthetic checkerboard renderer (``--synthetic N``).
Prints each view's grid, the RMS reprojection error (the reference's
target: under 0.3 px, src/CameraCalibrator.cc:145) and the parameters;
``--out`` writes them as a settings.cfg line (config/settings.cfg:7).
Runs on the card unless ``--device cpu``; ``main(argv)`` returns a
summary for callers in process.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

#: The synthetic views' camera (tests/test_calibrator.py's GT_PARAMS).
GT_PARAMS = (0.62, 0.82, 0.5, 0.5, 0.15)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ptam_cg_tpu_torch.apps.run_calib")
    ap.add_argument("images", nargs="?", default=None,
                    help="directory of grayscale checkerboard views")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="render N synthetic views instead of loading")
    ap.add_argument("--size", default="320x240",
                    help="image size for --synthetic (WxH)")
    ap.add_argument("--iters", type=int, default=100,
                    help="joint GN iterations (0.1-damped steps)")
    ap.add_argument("--out", default=None, metavar="CFG",
                    help="write Camera.Parameters in settings.cfg format")
    ap.add_argument("--device", default="cuda",
                    help="the calibrator's device (default: the card)")
    args = ap.parse_args(argv)
    if not args.synthetic and args.images is None:
        ap.error("give IMAGE_DIR or --synthetic N")
    return args


def synthetic_views(n, size, params, blur=0.6, device="cuda"):
    """``n`` checkerboard views at strong tilts (near-frontal views leave
    focal length and distortion poorly conditioned), rendered at twice
    the size and half-sampled for anti-aliased edges; the twists are
    ``examples/run_calib.py``'s draws from ``np.random.RandomState(3)``."""
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.ops import image as imops
    from ptam_cg_tpu_torch.utils import se3 as se3lib

    rng = np.random.RandomState(3)
    big = (size[0] * 2, size[1] * 2)
    cam2 = atan.make_camera(params, big, device)
    for _ in range(n):
        xi = np.array([
            rng.uniform(-1.0, 1.0), rng.uniform(-0.8, 0.8),
            rng.uniform(5.0, 7.0),
            rng.uniform(0.25, 0.6) * rng.choice([-1, 1]),
            rng.uniform(0.15, 0.55) * rng.choice([-1, 1]),
            rng.uniform(-0.6, 0.6)])
        pose = se3lib.se3_exp(torch.tensor(xi, dtype=torch.float32,
                                           device=device))
        im = imops.half_sample(synth.render_checkerboard(cam2, pose, big))
        if blur > 0:
            im = imops.gaussian_blur(im, blur)
        yield im


def main(argv=None) -> dict:
    """Calibrate. Returns {"params" (5,), "rms", "views": grid corners
    a view that joined, "calibrator": the ``CameraCalibrator``}; exits
    with status 1 with fewer than 2 views."""
    args = parse_args(argv)
    from ptam_cg_tpu_torch.camera import calibrator

    if args.synthetic:
        size = tuple(int(x) for x in args.size.split("x"))
        views = synthetic_views(args.synthetic, size, GT_PARAMS,
                                device=args.device)
    else:
        from ptam_cg_tpu_torch.io.tum import _load_image
        paths = sorted(p for p in Path(args.images).iterdir()
                       if p.suffix.lower() in (".pgm", ".png", ".npy"))
        if not paths:
            sys.exit(f"no .pgm/.png/.npy images in {args.images}")
        ims = [np.asarray(_load_image(str(p)), np.float32) for p in paths]
        size = (ims[0].shape[1], ims[0].shape[0])
        views = (torch.from_numpy(im) for im in ims)

    calib = calibrator.CameraCalibrator(size, device=args.device)
    grids = []
    for i, im in enumerate(views):
        if calib.add_image(im):
            grids.append(len(calib.views[-1].grid))
            print(f"view {i}: grid ok, {grids[-1]} grid corners")
        else:
            print(f"view {i}: no grid found (skipped)")
    if len(grids) < 2:
        print("need at least 2 usable views (the calibrator optimizes "
              "across several grabs)")
        sys.exit(1)

    rms = np.inf
    for it in range(args.iters):
        rms = calib.optimize_step()
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:3d}: RMS reprojection {rms:.4f} px")
    fx, fy, cx, cy, wd = calib.params
    print(f"\ncalibrated over {len(grids)} views, final RMS {rms:.4f} px "
          f"(reference target < 0.3 px)")
    line = (f"Camera.Parameters=[ {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f} "
            f"{abs(wd):.6f} ]")
    print(line)
    if args.synthetic:
        err = np.abs(np.array(calib.params[:4]) - np.array(GT_PARAMS[:4]))
        print(f"# synthetic GT {GT_PARAMS}; |err| fx/fy/cx/cy "
              f"{err.max():.4f}, |w| err {abs(abs(wd) - GT_PARAMS[4]):.4f}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("// saved by ptam_cg_tpu_torch.apps.run_calib "
                    "(CameraCalibrator::SaveCalibration)\n")
            f.write(line + "\n")
        print(f"wrote {args.out}")
    return dict(params=np.array(calib.params), rms=rms, views=grids,
                calibrator=calib)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main()
