"""The PyTorch operations one tracked frame dispatches, by the function of
the tracking step that dispatches them (the PyTorch port,
``ptam_cg_tpu_torch``).

    python3 profile_track_ops.py [--size W H] [--points N] [--device D]

Tracks frame 1 of ``chip_smoke.py``'s planar scene (``synth``'s
``planar_map_scene``) with ``tracker.track_frame_from_image`` and counts
every ATen operation it dispatches (a ``TorchDispatchMode``), each under
the outermost of these functions it runs in: ``pose_gn`` (K4's loop),
``calc_sbi_rotation`` (K5's loop and ``se3_from_se2``),
``subpix_refine`` (K6's loop), ``ssd_search``, ``build_frame_tracking`` (the
frontend), and "the rest". An operation that makes no tensor on the
device (a view, a shape query) counts too, so this is a proxy for the
kernels a CUDA graph of the step holds, not a count of them. On the
card (the default) K1-K6 are one operation each; with ``--device cpu``
every kernel wrapper runs its plain version instead, which counts the
operations of the loops the kernels replace. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)


class Counts(TorchDispatchMode):
    """ATen operations by the label on top of ``self.stack``."""

    def __init__(self):
        super().__init__()
        self.stack, self.n = [], {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = self.stack[0] if self.stack else "the rest"
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def labelled(counts, mod, name):
    """Replace ``mod.name`` by a wrapper that labels what it dispatches."""
    fn = getattr(mod, name)

    def wrapped(*a, **kw):
        counts.stack.append(name)
        try:
            return fn(*a, **kw)
        finally:
            counts.stack.pop()
    setattr(mod, name, wrapped)
    return mod, name, fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=(320, 240))
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import pose_gn
    from ptam_cg_tpu_torch.models import keyframe, tracker
    from ptam_cg_tpu_torch.ops import patch, sbi

    size, dev = tuple(args.size), torch.device(args.device)
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=size, n_frames=2,
                                  seed=7, height=1.5, radius=0.2, sweep=0.6,
                                  device=dev)
    m, ff0 = synth.planar_map_scene(seq, max_points=args.points,
                                    per_level=512, max_kfs=4)
    cam_params = torch.tensor(REF_PARAMS, device=dev)
    im = seq.frame(1)
    counts = Counts()
    saved = [labelled(counts, *t) for t in (
        (pose_gn, "pose_gn"), (sbi, "calc_sbi_rotation"),
        (patch, "subpix_refine"), (patch, "ssd_search"),
        (keyframe, "build_frame_tracking"))]
    try:
        with counts:
            out = tracker.track_frame_from_image(
                tracker.init_tracker_state(seq.pose(0), seed=0), m, im,
                ff0.sbi_track, seq.cam, size, cam_params)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    total = sum(counts.n.values())
    print(json.dumps({
        "device": str(dev), "size": list(size),
        "points": int(m.point_valid.sum()),
        "found": int(out.result.meas_valid.sum()), "ops": total,
        "by_function": {k: [v, round(100.0 * v / total, 1)] for k, v in
                        sorted(counts.n.items(), key=lambda kv: -kv[1])}}))


if __name__ == "__main__":
    main()
