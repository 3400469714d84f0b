"""Point-sharded global BA (``parallel/sharded_ba.py``) and the mesh
helpers: the PyTorch port against the JAX package.

The problems are tests/test_sharded_ba.py's (``test_bundle.make_problem``:
4 cameras, 64 points, 512 measurements; seed 21 perturbed, seed 22 with
12 outliers, seed 24 for the checkpoint), built once with numpy and
handed to both packages. JAX runs ``compute_sharded`` on the conftest's
8-virtual-device mesh; the port runs it on 4 gloo ranks and on the first
2 of them, in one group of processes (``tests/torch_dist_worker.py``,
results through files, a deadline on every rank), and its one-process
``bundle.compute`` in this process. Bars (test_torch_mapmaker.py's BA
bars): poses within 1e-4, points within 1e-3, the same measurements
pruned; the ranks of a mesh end bit-identical. A checkpoint written on 4 ranks after one chunk
resumes on 2 (elastic), and one written by JAX's ``compute_sharded``
resumes in the port, both ending within the same bars of the
uninterrupted run. The sharded step's stretches as graphs
(``ShardedPrograms``, replayed as on the card through
``torch_dist_worker.Emulated``) equal the eager stretches bit for bit, on
2 gloo ranks and on a one-rank mesh.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_dist_worker as tdw
from test_bundle import REF_PARAMS, SIZE, make_problem
from ptam_cg_tpu.parallel import sharded_ba as jsharded
from ptam_cg_tpu_torch.config import BundleConfig, MapMakerConfig
from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.models import bundle as tbundle
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import mapmaker as tmm
from ptam_cg_tpu_torch.parallel import mesh as meshlib
from ptam_cg_tpu_torch.parallel import sharded_ba
from ptam_cg_tpu_torch.utils.mest import TUKEY

torch.set_num_threads(2)

POSE_TOL = 1e-4
POINT_TOL = 1e-3
CASES = {"A": dict(seed=21, perturb_cams=0.02, perturb_pts=0.05),
         "B": dict(seed=22, perturb_pts=0.02, outliers=12),
         "C": dict(seed=24, perturb_cams=0.02, perturb_pts=0.05)}


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("mp",))


@pytest.fixture(scope="module")
def problems():
    return {k: make_problem(**kw)[:2] for k, kw in CASES.items()}


def _np_problem(prob):
    return {f: np.asarray(getattr(prob, f)) for f in tdw.PROB_FIELDS}


@pytest.fixture(scope="module")
def jax_runs(problems, jmesh):
    return {k: jsharded.compute_sharded(p, jmesh, cam)[0]
            for k, (p, cam) in problems.items()}


@pytest.fixture(scope="module")
def ranks(problems, jmesh, tmp_path_factory):
    """The ``ba`` scenario on 4 gloo ranks; the JAX checkpoint it resumes
    is case C interrupted after one chunk on the 8-device mesh."""
    work = tmp_path_factory.mktemp("sharded_ba")
    arrays = {}
    for k, (p, _) in problems.items():
        arrays.update({f"{k}.{f}": v for f, v in _np_problem(p).items()})
    cam = problems["A"][1]
    np.savez(work / "inputs.npz", cam_params=np.asarray(cam.params),
             image_size=np.array(SIZE), **arrays)
    calls = [0]

    def abort_after_1():
        calls[0] += 1
        return calls[0] >= 1

    jsharded.compute_sharded(problems["C"][0], jmesh, problems["C"][1],
                             abort_check=abort_after_1,
                             checkpoint_path=str(work / "jax_ckpt.npz"),
                             checkpoint_every=1)
    return tdw.launch("ba", 4, work, deadline_s=240.0)


@pytest.fixture(scope="module")
def graph_ranks(problems, tmp_path_factory):
    """The ``ba_graphs`` scenario on 2 gloo ranks: cases A and B with the
    sharded step's stretches as emulated graphs and eagerly."""
    work = tmp_path_factory.mktemp("sharded_ba_graphs")
    arrays = {}
    for k in ("A", "B"):
        arrays.update({f"{k}.{f}": v
                       for f, v in _np_problem(problems[k][0]).items()})
    cam = problems["A"][1]
    np.savez(work / "inputs.npz", cam_params=np.asarray(cam.params),
             image_size=np.array(SIZE), **arrays)
    return tdw.launch("ba_graphs", 2, work, deadline_s=240.0)


def _port_problem(prob):
    return fj.bundle_problem_from_numpy(fj.as_numpy_tree(prob), "cpu")


def _close(res, key, want_R, want_t, want_pts, want_bad):
    dR = np.abs(res[f"{key}.cam_R"] - want_R).max()
    dt = np.abs(res[f"{key}.cam_t"] - want_t).max()
    dp = np.abs(res[f"{key}.pt_pos"] - want_pts).max()
    assert dR < POSE_TOL and dt < POSE_TOL, (key, dR, dt)
    assert dp < POINT_TOL, (key, dp)
    np.testing.assert_array_equal(res[f"{key}.meas_bad"], want_bad)


def _jax_arrays(state):
    p = state.problem
    return (np.asarray(p.cam_R), np.asarray(p.cam_t), np.asarray(p.pt_pos),
            np.asarray(p.meas_bad))


@pytest.mark.parametrize("case", ["A", "B"])
@pytest.mark.parametrize("world", [4, 2])
def test_compute_sharded_matches_jax_and_one_process(case, world, ranks,
                                                     jax_runs, problems):
    res = ranks[0]
    key = f"{case}{world}"
    _close(res, key, *_jax_arrays(jax_runs[case]))
    prob, cam = problems[case]
    one, _ = tbundle.compute(_port_problem(prob),
                             fj.camera_from_numpy(fj.as_numpy_tree(cam),
                                                  "cpu"))
    p = one.problem
    _close(res, key, p.cam_R.numpy(), p.cam_t.numpy(), p.pt_pos.numpy(),
           p.meas_bad.numpy())
    # The ranks of the mesh end bit-identical.
    for other in ranks[1:world]:
        for f in ("cam_R", "cam_t", "pt_pos", "meas_bad", "flags"):
            np.testing.assert_array_equal(other[f"{key}.{f}"],
                                          res[f"{key}.{f}"])
    if case == "B":
        out_idx = make_problem(**CASES["B"])[3]
        assert res[f"{key}.meas_bad"][out_idx].mean() > 0.7


def test_checkpoint_resumes_across_world_sizes_and_packages(ranks,
                                                            jax_runs):
    res = ranks[0]
    iters, n1, ckpt_iters = res["part.flags"]
    assert n1 == 1 and ckpt_iters == iters
    want = _jax_arrays(jax_runs["C"])
    # Resumed on 2 ranks: the checkpoint's measurement order is the
    # 4-rank shard order; map it back through JAX's 4-device permutation
    # (the same as the port's, test below) to compare.
    perm4, _ = jsharded._shard_permutation(
        np.asarray(jax_runs["C"].problem.meas_pt),
        np.asarray(jax_runs["C"].problem.meas_valid), 64 // 4, 4)
    perm8, _ = jsharded._shard_permutation(
        np.asarray(jax_runs["C"].problem.meas_pt),
        np.asarray(jax_runs["C"].problem.meas_valid), 64 // 8, 8)
    for key, perm in (("C_resumed2", perm4), ("C_jax_resumed2", perm8)):
        assert res[f"{key}.flags"][4] >= 1
        live = perm >= 0
        bad = np.zeros_like(want[3])
        bad[perm[live]] = res[f"{key}.meas_bad"][live]
        got = {f"{key}.cam_R": res[f"{key}.cam_R"],
               f"{key}.cam_t": res[f"{key}.cam_t"],
               f"{key}.pt_pos": res[f"{key}.pt_pos"],
               f"{key}.meas_bad": bad}
        _close(got, key, *want)
        np.testing.assert_array_equal(ranks[1][f"{key}.pt_pos"],
                                      res[f"{key}.pt_pos"])


def test_hybrid_mesh_reduces_along_both_axes(ranks):
    np.testing.assert_array_equal(ranks[0]["hybrid_grid"],
                                  [[0, 1], [2, 3]])
    # chip sums (1+2, 3+4) within a host, host sums across: 10.
    want = [(3, 10, 0, 0), (3, 10, 0, 1), (7, 10, 1, 0), (7, 10, 1, 1)]
    for r, res in enumerate(ranks):
        assert tuple(res["hybrid"]) == want[r]
        assert tuple(res["mesh_sizes"]) == ((4, 2) if r < 2 else (4, -1))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_problem_permutation_and_padding_equal_jax(D, problems):
    prob, _ = problems["B"]
    jmesh = JMesh(np.array(jax.devices()[:D]), ("mp",))
    jsh, jperm = jsharded.shard_problem(prob, jmesh, return_perm=True)
    tprob = _port_problem(prob)
    shards = []
    for r in range(D):
        sh, perm = sharded_ba.shard_problem(
            tprob, meshlib.Mesh(None, D, r, torch.device("cpu")),
            return_perm=True)
        np.testing.assert_array_equal(perm, jperm)
        shards.append(sh)
    for f in tdw.PROB_FIELDS:
        if f.startswith("cam_"):
            continue
        got = torch.cat([getattr(s, f) for s in shards]).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jsh, f)), f)


def test_mesh_helpers(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert meshlib.initialize_distributed() is False
    m = meshlib.make_map_mesh(device="cpu")
    assert (m.size, m.rank, m.shape, m.backend) == (1, 0, {"mp": 1}, "none")
    x = torch.arange(3.0)
    assert torch.equal(m.all_reduce(x), x) and torch.equal(m.all_gather(x), x)
    assert m.agree(2.5) == 2.5
    with pytest.raises(ValueError):
        meshlib.make_map_mesh(2, device="cpu")
    assert meshlib.pad_to_multiple(1000, 8) == 1000
    assert meshlib.pad_to_multiple(1001, 8) == 1008


def test_indivisible_capacity_raises():
    """tests/test_engine_sharded_ba.py's problem (12 points on 8 shards)
    at the shard step, and a MapMaker whose point capacity the mesh does
    not divide, at construction."""
    mesh8 = meshlib.Mesh(None, 8, 0, torch.device("cpu"))
    C, P, M = 2, 12, 8
    prob = tbundle.BundleProblem(
        cam_R=torch.eye(3).repeat(C, 1, 1), cam_t=torch.zeros(C, 3),
        cam_fixed=torch.zeros(C, dtype=torch.bool),
        cam_valid=torch.ones(C, dtype=torch.bool), pt_pos=torch.zeros(P, 3),
        pt_valid=torch.ones(P, dtype=torch.bool),
        meas_cam=torch.zeros(M, dtype=torch.int32),
        meas_pt=torch.zeros(M, dtype=torch.int32),
        meas_pos=torch.zeros(M, 2), meas_sqrt_inv_noise=torch.ones(M),
        meas_valid=torch.ones(M, dtype=torch.bool),
        meas_bad=torch.zeros(M, dtype=torch.bool))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_ba.shard_problem(prob, mesh8)
    cam = tatan.make_camera(REF_PARAMS, SIZE, "cpu")
    m = tms.empty_map(SIZE, max_points=12, max_kfs=4, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmm.MapMaker(m, cam, SIZE, MapMakerConfig(), BundleConfig(),
                     mesh=mesh8)
    # A mesh that divides the capacity is taken; a one-rank mesh runs
    # unsharded.
    m = tms.empty_map(SIZE, max_points=1024, max_kfs=4, device="cpu")
    assert tmm.MapMaker(m, cam, SIZE, mesh=mesh8)._use_sharded
    one = meshlib.make_map_mesh(device="cpu")
    assert not tmm.MapMaker(m, cam, SIZE, mesh=one)._use_sharded


def test_sharded_step_on_one_rank_equals_lm_step(problems):
    """A one-rank mesh (no process group) runs the sharded step's code
    with identity collectives: one step equals ``bundle.lm_step``'s in
    flags and pruned set, poses within 1e-5 and points within 1e-4 (the
    sigma's median is the same; the sums run in the shard's order)."""
    prob, cam = problems["A"]
    tprob = _port_problem(prob)
    tcam = fj.camera_from_numpy(fj.as_numpy_tree(cam), "cpu")
    one = meshlib.make_map_mesh(device="cpu")
    shard, perm = sharded_ba.shard_problem(tprob, one, return_perm=True)
    s1, f1 = sharded_ba.sharded_lm_step_flags(
        sharded_ba.init_sharded_lm(shard, one), one, tcam)
    s0, f0 = tbundle.lm_step_flags(tbundle.init_lm(tprob), tcam)
    assert f1 == f0
    step = sharded_ba.make_sharded_lm_step(one, tcam)
    assert torch.equal(step(sharded_ba.init_sharded_lm(shard, one)
                            ).problem.pt_pos, s1.problem.pt_pos)
    back = sharded_ba.unshard_measurements(tprob, s1.problem, perm, one)
    assert torch.equal(back.meas_bad, s0.problem.meas_bad)
    assert (back.cam_R - s0.problem.cam_R).abs().max() < 1e-5
    assert (back.pt_pos - s0.problem.pt_pos).abs().max() < 1e-4
    lean = dataclasses.replace(BundleConfig(), soff_tiles=8, u_chunks=8)
    s2, f2 = sharded_ba.sharded_lm_step_flags(
        sharded_ba.init_sharded_lm(shard, one, lean), one, tcam, lean)
    assert f2 == f1 and torch.equal(s2.problem.pt_pos, s1.problem.pt_pos)


def test_ba_problem_large_matches_jax():
    """``synth.ba_problem_large`` (the chip check's sharded problem) is
    test_sharded_ba.py's ``make_problem_large``, at a small size: the same
    measurement table, positions within 1e-3 px, poses within 1e-6."""
    from test_sharded_ba import make_problem_large
    from ptam_cg_tpu_torch.io import synth as tsynth
    want, _, (jR, jt, jpts) = make_problem_large(n_cams=8, n_pts=512)
    got, _, (R, t, pts) = tsynth.ba_problem_large(n_cams=8, n_pts=512,
                                                  device="cpu")
    for f in ("meas_cam", "meas_pt", "meas_valid", "cam_fixed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.meas_pos.numpy(),
                               np.asarray(want.meas_pos), atol=1e-3)
    for f in ("cam_R", "cam_t", "pt_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6)


@pytest.mark.parametrize("case", ["A", "B"])
def test_sharded_programs_equal_eager_on_two_ranks(case, graph_ranks):
    """The sharded step's four stretches as graphs (``ShardedPrograms``,
    replayed as the card replays them, ``graphs.emulate``) equal the
    eager stretches bit for bit on each of 2 gloo ranks, which end
    bit-identical."""
    for res in graph_ranks:
        for f in ("cam_R", "cam_t", "pt_pos", "meas_bad", "meas_valid",
                  "flags"):
            np.testing.assert_array_equal(res[f"{case}.graphed.{f}"],
                                          res[f"{case}.eager.{f}"], f)
        for f in ("cam_R", "cam_t", "pt_pos", "meas_bad", "flags"):
            np.testing.assert_array_equal(res[f"{case}.graphed.{f}"],
                                          graph_ranks[0][f"{case}.graphed."
                                                         f"{f}"], f)
    assert graph_ranks[0][f"{case}.graphed.flags"][0] > 0


def test_sharded_programs_on_one_rank(problems, monkeypatch):
    """A one-rank mesh: ``sharded_lm_chunk`` through ``ShardedPrograms``
    (emulated graphs, then eager jobs on the same buffers) equals it
    without programs bit for bit, chunk after chunk, on case A and then
    on case B through the same programs (the same key, another
    measurement layout, as a MapMaker's later BA run); the programs
    capture each stretch once and a MapMaker keeps one set a key."""
    monkeypatch.setattr(graphs, "Graph", tdw.Emulated)
    monkeypatch.setattr(graphs, "on_card", lambda device, flag: flag)
    one = meshlib.make_map_mesh(device="cpu")
    cfg = BundleConfig()
    starts, tcam = {}, None
    for case in ("A", "B"):
        prob, cam = problems[case]
        tcam = fj.camera_from_numpy(fj.as_numpy_tree(cam), "cpu")
        starts[case] = sharded_ba.init_sharded_lm(
            sharded_ba.shard_problem(_port_problem(prob), one), one, cfg)
    keys = {sharded_ba.ShardedPrograms.key_of(st, one, cfg, TUKEY)
            for st in starts.values()}
    assert len(keys) == 1
    assert not torch.equal(starts["A"].layout.pt_rank,
                           starts["B"].layout.pt_rank)
    progs = {"none": None,
             "graphed": sharded_ba.ShardedPrograms(starts["A"], one, tcam,
                                                   cfg, TUKEY),
             "eager": sharded_ba.ShardedPrograms(starts["A"], one, tcam, cfg,
                                                 TUKEY, graphs_on=False)}
    for case, start in starts.items():
        runs = {}
        for key, prog in progs.items():
            st, f, flags = start, tbundle.INIT_FLAGS, []
            for limit in (1, 3, 8):
                st, f = sharded_ba.sharded_lm_chunk(st, one, tcam, cfg,
                                                    TUKEY, limit, f, prog)
                flags.append(f)
            runs[key] = (st, flags)
            if prog is not None:
                assert prog.graphs == (key == "graphed")
                assert sorted(prog.jobs) == ["accumulate", "schur",
                                             "sigma", "trial"]
                if prog.graphs:
                    assert len(prog.captures) == 4
        for key in ("graphed", "eager"):
            assert runs[key][1] == runs["none"][1], (case, key)
            for f in ("cam_R", "cam_t", "pt_pos", "meas_bad"):
                assert torch.equal(getattr(runs[key][0].problem, f),
                                   getattr(runs["none"][0].problem, f)), (
                    case, key, f)
    start = starts["B"]
    m = tms.empty_map(SIZE, max_points=64, max_kfs=4, device="cpu")
    progs = tmm.MapPrograms(m, tcam, SIZE, MapMakerConfig(), TUKEY, True)
    a = progs.sharded(start, one, cfg)
    assert progs.sharded(start, one, cfg) is a and a.graphs
    assert a.captures is progs.captures
