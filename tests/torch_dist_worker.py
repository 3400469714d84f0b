"""Ranks of a ``torch.distributed`` gloo group for the port's sharded-BA
tests: ``launch`` starts one process a rank running this file, each rank
writes its results to ``WORKDIR/<scenario>_rank<r>.npz``, and the test
reads those files (never the ranks' interleaved logs). Every rank has a
deadline: past it the ranks are killed and the test fails.

    python tests/torch_dist_worker.py SCENARIO RANK WORLD PORT WORKDIR

The ranks import the port only (no JAX); the tests put their inputs in
WORKDIR first (``inputs.npz``, ``frames.npy``, ``draws.npz``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PROB_FIELDS = ("cam_R", "cam_t", "cam_fixed", "cam_valid", "pt_pos",
               "pt_valid", "meas_cam", "meas_pt", "meas_pos",
               "meas_sqrt_inv_noise", "meas_valid", "meas_bad")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario: str, world: int, workdir, deadline_s: float = 240.0):
    """Run ``scenario`` on ``world`` gloo ranks; returns each rank's
    results (dicts of arrays). Raises if a rank fails or the deadline
    passes (the ranks are then killed)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    logs = [open(Path(workdir) / f"{scenario}_rank{r}.log", "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world), str(port),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{scenario}: ranks past their {deadline_s} s "
                             "deadline")
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (Path(workdir) / f"{scenario}_rank{r}.log").read_text()
            raise AssertionError(f"{scenario} rank {r} exited "
                                 f"{p.returncode}:\n{tail[-3000:]}")
    return [dict(np.load(Path(workdir) / f"{scenario}_rank{r}.npz"))
            for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _problem(data, prefix):
    import torch
    from ptam_cg_tpu_torch.models import bundle
    return bundle.BundleProblem(**{
        f: torch.from_numpy(np.array(data[f"{prefix}.{f}"]))
        for f in PROB_FIELDS})


def _save_state(out, key, state, n):
    p = state.problem
    out[f"{key}.cam_R"] = p.cam_R.numpy()
    out[f"{key}.cam_t"] = p.cam_t.numpy()
    out[f"{key}.pt_pos"] = p.pt_pos.numpy()
    out[f"{key}.meas_bad"] = p.meas_bad.numpy()
    out[f"{key}.meas_valid"] = p.meas_valid.numpy()
    out[f"{key}.flags"] = np.array([int(state.iters), int(state.accepted),
                                    int(state.converged), int(state.failed),
                                    n])


def scenario_ba(rank, world, workdir, out):
    """The sharded BA cases on 4 ranks and on the first 2, the checkpoint
    written on 4 and resumed on 2, a JAX checkpoint resumed on 2, and the
    hybrid (host, chip) mesh."""
    import torch
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.io.checkpoint import load_ba_state
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    from ptam_cg_tpu_torch.parallel import sharded_ba

    data = np.load(Path(workdir) / "inputs.npz")
    cam = atan.make_camera(tuple(data["cam_params"]),
                           tuple(int(v) for v in data["image_size"]), "cpu")
    m4 = meshlib.make_map_mesh(device="cpu")
    m2 = meshlib.make_map_mesh(2, device="cpu")
    out["mesh_sizes"] = np.array([m4.size, -1 if m2 is None else m2.size])
    for case in ("A", "B", "C"):
        st, n = sharded_ba.compute_sharded(_problem(data, case), m4, cam)
        _save_state(out, f"{case}4", st, n)
        if m2 is not None:
            st, n = sharded_ba.compute_sharded(_problem(data, case), m2, cam)
            _save_state(out, f"{case}2", st, n)
    # Interrupted on 4 ranks after one chunk, checkpointed every chunk.
    ckpt = str(Path(workdir) / "ckpt4.npz")
    calls = [0]

    def abort_after_1():
        calls[0] += 1
        return calls[0] >= 1

    part, n1 = sharded_ba.compute_sharded(
        _problem(data, "C"), m4, cam, abort_check=abort_after_1,
        checkpoint_path=ckpt, checkpoint_every=1)
    out["part.flags"] = np.array([int(part.iters), n1,
                                  int(load_ba_state(ckpt, "cpu").iters)])
    m4.barrier()
    if m2 is not None:
        st, n = sharded_ba.resume_sharded(ckpt, m2, cam)
        _save_state(out, "C_resumed2", st, n)
        st, n = sharded_ba.resume_sharded(
            str(Path(workdir) / "jax_ckpt.npz"), m2, cam)
        _save_state(out, "C_jax_resumed2", st, n)
    m4.barrier()
    # The hybrid mesh: 2 hosts of 2 ranks; a sum along "chip" then "host".
    hm = meshlib.make_hybrid_mesh(local_size=2, device="cpu")
    x = torch.tensor([float(rank + 1)])
    along_chip = hm.meshes["chip"].all_reduce(x)
    total = hm.meshes["host"].all_reduce(along_chip)
    out["hybrid"] = np.array([along_chip.item(), total.item(),
                              hm.meshes["host"].rank,
                              hm.meshes["chip"].rank])
    out["hybrid_grid"] = hm.grid


class Emulated:
    """``graphs.Graph`` on the CPU (tests/test_torch_map_programs.py's
    ``_Emulated``): the warm-up on clones of the inputs, then each replay
    runs the function on its capture's path (``graphs.emulate``) and copies
    the outputs into the first replay's, as a graph's are overwritten."""

    def __init__(self, fn, inputs, debug_path=None, pool=None):
        from ptam_cg_tpu_torch.models import graphs
        with graphs.warm():
            fn(*graphs.clone(inputs))
        self.fn, self.inputs, self.outputs = fn, inputs, None
        self.capture_s, self.launches, self.n_if = 0.0, {}, 0

    def replay(self, name=None):
        from ptam_cg_tpu_torch.models import graphs
        with graphs.emulate():
            out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        for buf, x in zip(graphs.tree.tensors(self.outputs),
                          graphs.tree.tensors(out)):
            if buf is not x:
                buf.copy_(x)
        return self.outputs


def emulate_graphs():
    """Programs asked for as graphs take the graph path on the CPU."""
    from ptam_cg_tpu_torch.models import graphs
    graphs.Graph = Emulated
    graphs.on_card = lambda device, flag: flag


def scenario_ba_graphs(rank, world, workdir, out):
    """Cases A and B of the ``ba`` scenario on the ranks, with the sharded
    step's stretches as emulated graphs (``ShardedPrograms``) and eagerly;
    and case B's first chunk through a MapMaker-style cache."""
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    from ptam_cg_tpu_torch.parallel import sharded_ba

    data = np.load(Path(workdir) / "inputs.npz")
    cam = atan.make_camera(tuple(data["cam_params"]),
                           tuple(int(v) for v in data["image_size"]), "cpu")
    mesh = meshlib.make_map_mesh(device="cpu")
    emulate_graphs()
    for case in ("A", "B"):
        for key, on in (("graphed", True), ("eager", False)):
            st, n = sharded_ba.compute_sharded(_problem(data, case), mesh,
                                               cam, graphs=on)
            _save_state(out, f"{case}.{key}", st, n)


class ReplayDraws:
    """The draws a reference run recorded (``draws.npz``: ``k<i>.<kind>``
    in call order), handed out in the same order; a call of another kind
    than recorded raises."""

    def __init__(self, path):
        import torch
        data = np.load(path)
        self._calls = []
        i = 0
        while any(k.startswith(f"k{i}.") for k in data.files):
            kind = next(k for k in data.files
                        if k.startswith(f"k{i}."))
            self._calls.append((kind.split(".", 1)[1], [
                torch.from_numpy(np.array(data[k])) for k in sorted(
                    (k for k in data.files if k.startswith(f"k{i}.")))]))
            i += 1
        self._i = 0

    def _next(self, kind):
        got, vals = self._calls[self._i]
        if got.split(".")[0] != kind:
            raise AssertionError(f"draw {self._i}: {kind}, recorded {got}")
        self._i += 1
        return vals

    def rekey_tracker(self):
        self._next("rekey")

    def reset_mapmaker(self):
        self._next("reset")

    def track(self, n, out=None):
        return tuple(self._next("track"))

    def mlesac(self, trials, n):
        return self._next("mlesac")[0]

    def plane(self, n_ransacs, n):
        return self._next("plane")[0]


def scenario_engine(rank, world, workdir, out):
    """The engine with a 2-rank mesh on the test's frames: deterministic
    with the recorded draws, then latency mode with the default draws."""
    from ptam_cg_tpu_torch import config as tc
    from ptam_cg_tpu_torch.models import engine
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    from ptam_cg_tpu_torch.parallel import sharded_ba

    meta = np.load(Path(workdir) / "meta.npz")
    frames = np.load(Path(workdir) / "frames.npy")
    params = tuple(float(v) for v in meta["params"])
    size = tuple(int(v) for v in meta["size"])
    mesh = meshlib.make_map_mesh(device="cpu")
    shards = [0]
    orig = sharded_ba.shard_problem

    def counting(*a, **kw):
        shards[0] += 1
        return orig(*a, **kw)

    sharded_ba.shard_problem = counting
    cfg = tc.EngineConfig(
        camera=tc.CameraConfig(params=params, image_size=size),
        mapmaker=tc.MapMakerConfig(
            candidate_min_shi_tomasi_score=float(meta["cand_min"])))
    for key, det, draws in (
            ("det", True, ReplayDraws(Path(workdir) / "draws.npz")),
            ("latency", False, None)):
        shards[0] = 0
        eng = engine.SLAMEngine(
            cfg, image_size=size, max_points=int(meta["P"]),
            max_kfs=int(meta["K"]), auto_init_frames=6, seed=0,
            deterministic=det, device="cpu", draws=draws, mesh=mesh)
        infos = [eng.process_frame(im) for im in frames]
        out[f"{key}.outcome"] = np.array([
            [("NOT_STARTED", "TRAIL_TRACKING", "TRACKING").index(i.stage),
             i.quality, i.added_kf, i.relocalized, i.n_kfs, i.n_found,
             i.n_points] for i in infos])
        out[f"{key}.R"] = np.stack([i.pose.R.numpy() for i in infos])
        out[f"{key}.t"] = np.stack([i.pose.t.numpy() for i in infos])
        out[f"{key}.shards"] = np.array([shards[0],
                                         int(eng.mapmaker._use_sharded)])


def main():
    scenario, rank, world, port, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    from ptam_cg_tpu_torch.parallel import mesh as meshlib
    assert meshlib.initialize_distributed(
        f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120.0)
    out = {}
    {"ba": scenario_ba, "ba_graphs": scenario_ba_graphs,
     "engine": scenario_engine}[scenario](rank, world, workdir, out)
    torch.distributed.barrier()
    np.savez(Path(workdir) / f"{scenario}_rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
