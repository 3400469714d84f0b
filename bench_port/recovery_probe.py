"""A one-off probe of recovery, not a cell: does the engine relocalize after
the camera is covered, and how long does it take?

    python3 bench_port/recovery_probe.py [--config tum_fr1_desk] [--seed N]

Builds the settled map as a benchmark run's set-up does (synchronous
engine), then hands frames over at the camera's rate: 10 s of the sweep,
``--covered`` seconds of black frames (a hand over the lens), and 10 s of
the sweep again. Prints one JSON line: the frames covered, whether and when
tracking came back (GOOD again, with a relocalization), the seconds from the
first uncovered frame's due time to that frame's return, and its pose error
after the set-up's similarity. Any exception is printed with its traceback.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="tum_fr1_desk")
    ap.add_argument("--seed", type=int, default=3_100_000_001)
    ap.add_argument("--covered", type=float, default=1.5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from bench_port import cell as celllib
    from bench_port import reference, scene
    from bench_port.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = Spec().config(args.config)
    seq = scene.Sequence(cfg, args.seed, "cuda")
    eng = celllib.make_engine(cfg, args.seed, "cuda")
    fps = float(cfg["camera"]["fps"])
    ks, infos, due, ret = [], [], [], []
    try:
        k = 0
        for _ in range(celllib.MIN_SWEEPS):
            for _ in range(2 * seq.path.n_sweep):
                infos.append(eng.process_frame(seq.frame(k)))
                ks.append(k)
                k += 1
        n_setup = len(infos)
        black = np.zeros_like(seq.frame(0))
        n_before, n_cover = int(10 * fps), int(args.covered * fps)
        t0 = time.perf_counter()
        for i in range(n_before + n_cover + int(10 * fps)):
            d = t0 + i / fps
            now = time.perf_counter()
            if now < d:
                time.sleep(d - now)
            covered = n_before <= i < n_before + n_cover
            infos.append(eng.process_frame(black if covered else
                                           seq.frame(k)))
            ks.append(k)
            due.append(d)
            ret.append(time.perf_counter())
            k += 1
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        eng.close()
    first = n_setup + n_before + n_cover
    back = next((j for j in range(first, len(infos))
                 if infos[j].stage == "TRACKING" and infos[j].quality == 2),
                None)
    R = torch.stack([x.pose.R for x in infos]).double().cpu().numpy()
    t = torch.stack([x.pose.t for x in infos]).double().cpu().numpy()
    u = np.array([seq.index(x) for x in ks])
    tracked = np.zeros(len(infos), dtype=bool)
    tracked[:n_setup] = [x.stage == "TRACKING" for x in infos[:n_setup]]
    sim = reference.similarity(*reference.to_world(R[tracked], t[tracked]),
                               *reference.to_world(seq.R[u][tracked],
                                                   seq.t[u][tracked]))
    unit = float(np.linalg.norm(seq.path.centers, axis=-1).mean())
    out = {"config": args.config, "seed": args.seed,
           "covered_frames": n_cover,
           "lost_while_covered": sum(
               x.quality == 0 for x in infos[first - n_cover:first]),
           "relocalized_frames": [j - first for j in range(first, len(infos))
                                  if infos[j].relocalized],
           "recovered_frame": None if back is None else back - first}
    if back is not None:
        rot, pos = reference.pose_errors(sim, R[back:back + 1],
                                         t[back:back + 1], seq.R[u[back:]][:1],
                                         seq.t[u[back:]][:1], unit)
        j = back - n_setup
        out.update(recovery_s=ret[j] - due[first - n_setup],
                   rot_err=float(rot[0]), pos_err=float(pos[0]),
                   tracking_at_end=infos[-1].stage)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
