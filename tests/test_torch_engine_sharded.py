"""The engine with a 2-rank mesh: global BA point-sharded over two gloo
ranks (``SLAMEngine(mesh=...)``), against the port's unmeshed engine and
the JAX engine on the conftest's 8-device mesh.

The scene is tests/test_engine_sharded_ba.py's (test_slam_e2e.py's orbit:
320x240, 26 frames, 1024 points, 8 keyframes, auto-init after 6 frames,
candidate threshold 70), rendered by the JAX synth and rounded to uint8
as tests/test_torch_engine.py does. The unmeshed port engine runs here
on ``JaxDraws`` and records every draw; the two ranks
(``tests/torch_dist_worker.py``, a deadline on each) replay those draws
in deterministic mode, then run latency mode with their own default
draws. Bars: the ranks' ``FrameInfo``s are identical in both modes;
global BA ran sharded; per frame the same stage, quality, keyframes,
found and point counts as the unmeshed port engine and the meshed JAX
engine, and poses within test_torch_engine.py's scale-free bars
(``ROT_TOL``, ``T_TOL``): the sharded solve sums its blocks in another
order, which moves the map by float32 noise only.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_worker as tdw
from test_torch_engine import (CAND_MIN, K, N_FRAMES, P, REF_PARAMS, ROT_TOL,
                               SIZE, T_TOL, JaxDraws, _jcfg, _outcome,
                               _port_engine, _scaled_poses)
from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import engine as jengine

STAGES = ("NOT_STARTED", "TRAIL_TRACKING", "TRACKING")


class RecordingDraws(JaxDraws):
    """``JaxDraws`` that keeps every draw, in call order."""

    def __init__(self, seed=0):
        super().__init__(seed)
        self.calls = []

    def rekey_tracker(self):
        super().rekey_tracker()
        self.calls.append(("rekey", [np.zeros(0)]))

    def reset_mapmaker(self):
        super().reset_mapmaker()
        self.calls.append(("reset", [np.zeros(0)]))

    def track(self, n, out=None):
        out = super().track(n)
        self.calls.append(("track", [t.numpy() for t in out]))
        return out

    def mlesac(self, trials, n):
        out = super().mlesac(trials, n)
        self.calls.append(("mlesac", [out.numpy()]))
        return out

    def plane(self, n_ransacs, n):
        out = super().plane(n_ransacs, n)
        self.calls.append(("plane", [out.numpy()]))
        return out

    def save(self, path):
        np.savez(path, **{f"k{i}.{kind}.{j}": a
                          for i, (kind, arrs) in enumerate(self.calls)
                          for j, a in enumerate(arrs)})


@pytest.fixture(scope="module")
def frames():
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                  n_frames=N_FRAMES, seed=5, height=1.5,
                                  radius=0.35, sweep=1.3)
    return [np.clip(np.round(np.asarray(seq.frame(i))), 0, 255).astype(
        np.uint8) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def runs(frames, tmp_path_factory):
    work = tmp_path_factory.mktemp("engine_sharded")
    draws = RecordingDraws(0)
    eng = _port_engine(draws)
    port = [eng.process_frame(im) for im in frames]
    draws.save(work / "draws.npz")
    np.save(work / "frames.npy", np.stack(frames))
    np.savez(work / "meta.npz", params=np.array(REF_PARAMS),
             size=np.array(SIZE), cand_min=CAND_MIN, P=P, K=K)
    ranks = tdw.launch("engine", 2, work, deadline_s=300.0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("mp",))
    jeng = jengine.SLAMEngine(_jcfg(), image_size=SIZE, max_points=P,
                              max_kfs=K, auto_init_frames=6, seed=0,
                              deterministic=True, mesh=mesh)
    jax_meshed = [jeng.process_frame(im) for im in frames]
    assert jeng.mapmaker._use_sharded
    return ranks, port, jax_meshed


def _rank_outcome(res, key):
    return [(STAGES[o[0]], o[1], bool(o[2]), bool(o[3]), o[4], o[5], o[6])
            for o in res[f"{key}.outcome"].tolist()]


def _rank_scaled(res, key):
    stages = res[f"{key}.outcome"][:, 0]
    first = int(np.argmax(stages == 2))
    R = res[f"{key}.R"].astype(np.float64)
    t = res[f"{key}.t"].astype(np.float64)
    return R, t / np.linalg.norm(t[first]), first


@pytest.mark.parametrize("key", ["det", "latency"])
def test_ranks_agree_and_global_ba_ran_sharded(runs, key):
    ranks, _, _ = runs
    for f in ("outcome", "R", "t", "shards"):
        np.testing.assert_array_equal(ranks[1][f"{key}.{f}"],
                                      ranks[0][f"{key}.{f}"], f)
    n_shards, use_sharded = ranks[0][f"{key}.shards"]
    assert use_sharded == 1 and n_shards >= 1
    out = _rank_outcome(ranks[0], key)
    assert out[-1][0] == "TRACKING" and out[-1][6] > 100


@pytest.mark.parametrize("ref", ["port_unmeshed", "jax_meshed"])
def test_meshed_engine_matches(runs, ref):
    ranks, port, jax_meshed = runs
    want = port if ref == "port_unmeshed" else jax_meshed
    assert _rank_outcome(ranks[0], "det") == [_outcome(i) for i in want]
    wR, wt, first = _scaled_poses(want)
    gR, gt, g_first = _rank_scaled(ranks[0], "det")
    assert g_first == first
    d_R = max(np.abs(wR[k] - gR[k]).max() for k in range(first, N_FRAMES))
    d_t = max(np.abs(wt[k] - gt[k]).max() for k in range(first, N_FRAMES))
    print(f"\n2-rank engine vs {ref}: |dR| {d_R:.2e}, |dt| / |t| {d_t:.2e}")
    assert d_R <= ROT_TOL and d_t <= T_TOL, (d_R, d_t)
