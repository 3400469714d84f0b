"""Write a TUM-RGBD-format dataset (frames, ``rgb.txt``,
``groundtruth.txt``) from the port's synthetic renderer: the port's
counterpart of ``examples/make_synth_tum.py``, a stand-in for a recorded
sequence replayed through the reference's dataset path
(src/VideoSource.cc:59-159).

    python -m ptam_cg_tpu_torch.apps.make_synth_tum OUT_DIR [--frames N]
        [--size WxH] [--nonplanar] [--png] [--hostile]
        [--trajectory orbit|loop] [--motion-blur N]
        [--rolling-shutter F] [--radius R] [--seed S]
        [--device cuda|cpu]

Frames are rendered on ``--device`` (the card by default) and written as
``.npy`` (``--png``: 8-bit PNGs, which need PIL and the Python reader).
The texture is the port's own draw from the seed, so the frames are not
the JAX package's pixel for pixel.
"""

from __future__ import annotations

import argparse

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ptam_cg_tpu_torch.apps.make_synth_tum")
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--nonplanar", action="store_true",
                    help="add raised blocks (parallax and occlusion)")
    ap.add_argument("--png", action="store_true",
                    help="write 8-bit PNGs instead of .npy (needs PIL; the "
                         "native frame pump reads only .npy/.pgm)")
    ap.add_argument("--hostile", action="store_true",
                    help="photometric hostility: exposure and black-level "
                         "drift, sensor noise, vignette")
    ap.add_argument("--trajectory", choices=["orbit", "loop"],
                    default="orbit",
                    help="'loop' = a full circuit back to the start")
    ap.add_argument("--motion-blur", type=int, default=0,
                    help="exposure samples averaged a frame (0 = instant)")
    ap.add_argument("--rolling-shutter", type=float, default=0.0,
                    help="row-readout span as a fraction of the frame "
                         "period (row r lags by this * r/H)")
    ap.add_argument("--radius", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="the renderer's device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ptam_cg_tpu_torch.io import synth, tum

    w, h = (int(x) for x in args.size.split("x"))
    boxes = (synth.default_blocks(seed=2, n=4, device=args.device)
             if args.nonplanar else None)
    seq = synth.SyntheticSequence(
        REF_PARAMS, image_size=(w, h), n_frames=args.frames, seed=args.seed,
        height=1.5, radius=args.radius, sweep=1.3, boxes=boxes,
        trajectory=args.trajectory, hostile=args.hostile,
        motion_blur=args.motion_blur, rolling_shutter=args.rolling_shutter,
        device=args.device)
    frames = (seq.frame(i).cpu().numpy() for i in range(args.frames))
    poses = [seq.pose(i) for i in range(args.frames)]
    tum.write_synthetic_dataset(args.out, frames, poses=poses, png=args.png)
    kind = "PNG" if args.png else ".npy"
    print(f"wrote {args.frames} {kind} frames + groundtruth -> {args.out}")


if __name__ == "__main__":
    main()
