"""Readings that set the limits of ``correct``: the numbers ``reference.judge``
computes, run after run, for the program as configured and for its control.

    python3 bench_port/control.py --workload NAME --seconds S \
        --seeds N [N ...] [--control]

runs the cell once per seed in one process (set-up and window as a
benchmark run, at the cell's own size and load) and prints one JSON line a
seed: the seed, which path ran, and each number. ``--control`` runs the
program's own lower-precision path: the keyframe and frame atlases in
bfloat16 (``FrontendConfig.atlas_bf16``) and the ZMSSD search's cross term
in bfloat16 (``TrackerConfig.zmssd_bf16_cross``), where the configuration
states float32. ``--reference-bf16 FRAMES`` prints instead the numbers of
the reference itself put in the program's place in bfloat16, over a window
of FRAMES frames (``reference_bf16``). The benchmark's own runs never run
this script.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: The program's own lower-precision path, written over the configuration.
LOWER_PRECISION = {"engine": {"frontend": {"atlas_bf16": True},
                              "tracker": {"zmssd_bf16_cross": True}}}


def readings(spec, workload: str, seeds, seconds: float, control: bool,
             device="cuda"):
    """Yield (seed, the run's ``cell.Outcome``) of one run a seed: its
    ``checks`` are the numbers compared."""
    from bench_port import cell as celllib
    for seed in seeds:
        yield seed, celllib.run(spec, workload, seed, seconds, False, device,
                                time.perf_counter(),
                                overrides=LOWER_PRECISION if control
                                else None)


def reference_bf16(spec, workload: str, seed: int, n_window: int,
                   device="cuda") -> dict:
    """The numbers of the reference itself put in the program's place in
    bfloat16: every frame's true pose, a keyframe every 20 set-up frames
    (its true pose and its frame's pyramid), rounded to bfloat16, judged
    over a window of ``n_window`` frames as a run's. Where the mix covers
    the lens, the covered frames are left out and each event recovers on
    its first uncovered frame (an event the window's end cuts is left
    out). Where it explores, the set-up frames are the route's opening,
    the window is the rest of the route (``n_window`` is ignored), and a
    keyframe is made every 20 frames of the whole route, as the map grows
    along it."""
    import numpy as np
    import torch

    from bench_port import cell as celllib
    from bench_port import reference, scene
    from bench_port import traffic as trafficlib
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    mix = trafficlib.read(spec.traffic(cell["traffic"]), cfg["path"])
    covers = trafficlib.Covers(mix.get("cover"), seed)
    explore = mix.get("explore")
    if explore is None:
        seq = scene.Sequence(cfg, seed, device)
        n_setup = celllib.MIN_SWEEPS * 2 * seq.path.n_sweep + seq.path.ramp
    else:
        n_setup, n_window = explore["opening"], explore["frames"]
        seq = scene.Sequence(cfg, seed, device, n_setup + n_window)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            torch.bfloat16).double().numpy()

    ks = np.arange(n_setup + n_window)
    u = np.array([seq.index(int(k)) for k in ks])
    window = ks >= n_setup
    kf = u[:n_setup if explore is None else len(u):20]
    H, W = seq.frames.shape[1:]
    atlases = []
    for i in kf:
        lev = [bf16(x) for x in reference.pyramid(seq.frames[i])]
        atlas = np.zeros((H + H // 2, W))
        offs = ((0, 0), (H, 0), (H, W // 2), (H, W // 2 + W // 4))
        for (r, c), x in zip(offs, lev):
            atlas[r:r + x.shape[0], c:c + x.shape[1]] = x
        atlases.append(atlas)
    plane = np.array([[0.1, 0.2, 0.0], [-0.3, 0.1, 0.0]])
    reloc = None
    if covers.cover is not None:
        reloc = dict(pairs=[], unrecovered=0)
        i = 0
        while (back := covers.start(i) + covers.length(i)) < n_window:
            window[n_setup + covers.start(i): n_setup + back] = False
            reloc["pairs"].append((n_setup + covers.start(i) - 1,
                                   n_setup + back))
            i += 1
    return reference.judge(seq, ks, bf16(seq.R[u]), bf16(seq.t[u]),
                           np.ones(len(ks), dtype=bool), window,
                           bf16(seq.R[kf]), bf16(seq.t[kf]), atlases,
                           bf16(plane), reloc=reloc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--reference-bf16", type=int, metavar="FRAMES")
    args = ap.parse_args(argv)
    import torch

    from bench_port.spec import Spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.reference_bf16:
        for seed in args.seeds:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "path": "reference in bfloat16",
                              "checks": reference_bf16(
                                  Spec(ROOT), args.workload, seed,
                                  args.reference_bf16)}), flush=True)
        return 0
    path = "control" if args.control else "program"
    for seed, out in readings(Spec(ROOT), args.workload, args.seeds,
                              args.seconds, args.control):
        events = [n for n in out.notes if n.startswith("events:")]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "path": path, "checks": out.checks,
                          "events": events}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
