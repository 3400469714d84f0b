"""How far the engine on the card lies from the engine on the CPU, with
the sub-pixel refinement as K6 and as the plain loop (the path before
K6), over several draw seeds.

    python3 engine_parity.py [--frames N] [--seeds S ...] [--bf16]
        [--device cpu]

``chip_smoke.py`` phase 11b's scene and engine (deterministic, every
program eager, so each sub-pixel call passes through Python), three runs
for each seed of the engine's host draws: the card with K6, the card with
``kernels/subpix.subpix_refine_plain`` in its place, and the CPU.
``--bf16`` takes phase 19's configuration (bf16 atlases and ZMSSD
products). Printed for each pair of runs: the frames whose outcome
differs, the largest rotation and translation differences (each frame's
t over |t| on the init frame, as phase 11b reads them), the first frame
where either passes 1e-6, and the frames whose found counts or map sizes
differ; then, for K6's run against each other run, the first sub-pixel
call where the two part: whether its inputs were equal, whether its
outputs were, and the converged points that differ (with each one's
squared last step and whether ``utils/parity.py`` calls it at the
limit). A K6 call on the same inputs as the CPU's gives the same outputs
bit for bit, so a run parts from the CPU's first where an input differs.
Last, for each card run against the CPU's, the frames whose poses differ
by more than phase 11b's bars (8e-5, 5e-6), and the sub-pixel calls
(by frame) whose converged sets differ, with how many of those points
have a last step at the limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=49,
                    help="frames of phase 11's sequence (11b reads 49)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                    help="seeds of the engine's host draws (11b's is 0)")
    ap.add_argument("--bf16", action="store_true",
                    help="phase 19's bf16 configuration")
    ap.add_argument("--device", default="cuda",
                    help="the card's runs on this device instead (\"cpu\" "
                    "rehearses the script)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from ptam_cg_tpu_torch.config import (CameraConfig, EngineConfig,
                                          FrontendConfig, MapMakerConfig,
                                          TrackerConfig)
    from ptam_cg_tpu_torch.io import synth
    from ptam_cg_tpu_torch.kernels import subpix as ksubpix
    from ptam_cg_tpu_torch.models import engine as englib
    from ptam_cg_tpu_torch.utils import parity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    seq = synth.SyntheticSequence(cs.REF_PARAMS, image_size=cs.SIZE,
                                  device=dev, **cs.ENG_SEQ)
    frames = [seq.frame(i).clamp(0, 255).to(torch.uint8).cpu().numpy()
              for i in range(args.frames)]
    extra = (dict(frontend=FrontendConfig(atlas_bf16=True),
                  tracker=TrackerConfig(zmssd_bf16_cross=True))
             if args.bf16 else {})

    def make(device, seed):
        cfg = EngineConfig(
            camera=CameraConfig(params=cs.REF_PARAMS, image_size=cs.SIZE),
            mapmaker=MapMakerConfig(
                candidate_min_shi_tomasi_score=cs.ENG_CAND_MIN), **extra)
        return englib.SLAMEngine(cfg, image_size=cs.SIZE, device=device,
                                 **cs.ENG_MAP, deterministic=True,
                                 draws=cs.HostDraws(englib, seed, device),
                                 graphs=False)

    kernel = ksubpix.subpix_refine
    frame = [0]                             # the frame being processed

    def recorded(fn, log):
        def call(*a):
            out = fn(*a)
            log.append(([x.cpu().clone() if torch.is_tensor(x) else x
                         for x in a], [x.cpu().clone() for x in out],
                        frame[0]))
            return out
        return call

    def run(eng):
        infos = []
        for k, im in enumerate(frames):
            frame[0] = k
            infos.append(eng.process_frame(im))
        return infos

    def same(x, y):                         # NaN where the other has NaN
        return bool(((x == y) | ((x != x) & (y != y))).all())

    lo, hi = parity.STEP_BAND
    print(f"configuration {'bf16' if args.bf16 else 'float32'}, frames "
          f"0..{args.frames - 1}", flush=True)
    for seed in args.seeds:
        runs, logs = {}, {}
        for name, fn, device in (
                ("card K6", kernel, dev),
                ("card plain", ksubpix.subpix_refine_plain, dev),
                ("cpu", ksubpix.subpix_refine_plain, "cpu")):
            logs[name] = []
            ksubpix.subpix_refine = recorded(fn, logs[name])
            t0 = time.perf_counter()
            try:
                runs[name] = run(make(device, seed))
            finally:
                ksubpix.subpix_refine = kernel
            if dev.type == "cuda":
                torch.cuda.synchronize()
            print(f"seed {seed}: {name} {time.perf_counter() - t0:.1f} s, "
                  f"{len(logs[name])} sub-pixel calls", flush=True)
        first = next(k for k, i in enumerate(runs["cpu"])
                     if i.stage == "TRACKING")
        for a, b in (("card K6", "cpu"), ("card plain", "cpu"),
                     ("card K6", "card plain")):
            bad, d_R, d_t = cs.engine_diffs(runs[a], runs[b], first, torch)
            pa = cs.scaled_poses(runs[a], first, torch)
            pb = cs.scaled_poses(runs[b], first, torch)
            over = next(((k, float((x[0] - y[0]).abs().max()),
                          float((x[1] - y[1]).abs().max()))
                         for k, (x, y) in enumerate(zip(pa, pb))
                         if k >= first and (
                             float((x[0] - y[0]).abs().max()) > 1e-6
                             or float((x[1] - y[1]).abs().max()) > 1e-6)),
                        None)
            nf = [(k, x.n_found, y.n_found, x.n_points, y.n_points)
                  for k, (x, y) in enumerate(zip(runs[a], runs[b]))
                  if (x.n_found, x.n_points, x.n_kfs)
                  != (y.n_found, y.n_points, y.n_kfs)]
            print(f"seed {seed}: {a} vs {b}: outcome differences {bad}; "
                  f"|dR| {d_R:.2e} |dt|/|t| {d_t:.2e}; first frame over "
                  f"1e-6 (frame, |dR|, |dt|/|t|) {over}; found counts or "
                  f"points differing (frame, found, found, points, points) "
                  f"{nf[:8]}", flush=True)
        for name in ("card plain", "cpu"):
            parted = None
            for i, ((ia, oa, _), (ib, ob, _)) in enumerate(
                    zip(logs["card K6"], logs[name])):
                same_in = all(
                    (x.shape == y.shape and same(x, y))
                    if isinstance(x, torch.Tensor) else x == y
                    for x, y in zip(ia, ib))
                same_out = all(x.shape == y.shape and same(x, y)
                               for x, y in zip(oa, ob))
                if not (same_in and same_out):
                    idx = (torch.nonzero(oa[1] != ob[1])[:, 0].tolist()
                           if oa[1].shape == ob[1].shape else [])
                    conv = [(j, float(oa[2][j]), float(ob[2][j]),
                             lo * parity.CONV_LIMIT_SQ <= float(ob[2][j])
                             <= hi * parity.CONV_LIMIT_SQ) for j in idx[:6]]
                    parted = (f"call {i} of {len(logs[name])} (N="
                              f"{ia[0].shape[0]}, D={ia[3].shape[-1]}, "
                              f"{ia[5]} iterations): inputs equal {same_in}, "
                              f"outputs equal {same_out}; converged points "
                              f"differing {len(idx)} (point, K6 step^2, "
                              f"other step^2, at the limit) {conv}")
                    break
            print(f"seed {seed}: K6 against {name}: first parting "
                  f"{parted or 'none'}", flush=True)
        for name in ("card K6", "card plain"):
            pa = cs.scaled_poses(runs[name], first, torch)
            pb = cs.scaled_poses(runs["cpu"], first, torch)
            over = [(k, f"{float((x[0] - y[0]).abs().max()):.2e}",
                     f"{float((x[1] - y[1]).abs().max()):.2e}")
                    for k, (x, y) in enumerate(zip(pa, pb))
                    if k >= first and (
                        float((x[0] - y[0]).abs().max()) > cs.ENG_ROT_TOL
                        or float((x[1] - y[1]).abs().max()) > cs.ENG_T_TOL)]
            # The calls of each frame, in order; a frame whose calls differ
            # in number or shape between the runs is named apart.
            flips, unlike = [], []
            for k in range(len(frames)):
                ca = [c for c in logs[name] if c[2] == k]
                cb = [c for c in logs["cpu"] if c[2] == k]
                shapes = [[c[0][3].shape for c in calls] for calls in (ca, cb)]
                if shapes[0] != shapes[1]:
                    unlike.append((k, len(ca), len(cb)))
                    continue
                for j, ((_, oa, _), (_, ob, _)) in enumerate(zip(ca, cb)):
                    differ = oa[1] != ob[1]
                    if bool(differ.any()):
                        at = ((ob[2] >= lo * parity.CONV_LIMIT_SQ)
                              & (ob[2] <= hi * parity.CONV_LIMIT_SQ))
                        flips.append((k, j, oa[0].shape[0],
                                      int(differ.sum()),
                                      int((differ & at).sum())))
            print(f"seed {seed}: {name} against cpu: frames over 11b's bars "
                  f"(frame, |dR|, |dt|/|t|) {over[:12]}; calls whose "
                  f"converged sets differ (frame, call of the frame, N, "
                  f"points, at the limit) {flips[:12]}; frames whose calls "
                  f"differ in number or shape (frame, calls, CPU's calls) "
                  f"{unlike[:12]}", flush=True)


if __name__ == "__main__":
    main()
