"""The MapMaker's programs and BA's LM chunk as programs
(``ptam_cg_tpu_torch/models/mapmaker.py::MapPrograms``,
``ptam_cg_tpu_torch/models/bundle.py::ChunkProgram``): the JAX MapMaker's
jitted jobs, which the card replays as CUDA graphs with conditional
nodes.

On the CPU a program runs eagerly on its static buffers; ``_Emulated``
stands in for ``graphs.Graph`` and runs each replay on the path a capture
records (the jobs writing their buffers in place, every
``graphs.if_block`` and ``graphs.loop`` reading its predicate on the host
as its IF or WHILE node reads it on the card), after the same warm-up. Scenes
are tests/test_torch_mapmaker.py's (320x240 integration scene, 10-keyframe
``ba_map``, the 8-keyframe scheduler scene, 20-slot re-find spans) and
``synth.ba_problem``'s. Bars:

- the emulated program path equals the eager one bit for bit (every map
  field, mask, slot, count, LM state and flags); the eager LM chunk (try
  slots) equals a loop of ``lm_step_flags`` (the chunk before the slots)
  bit for bit, lambda retries, a step that runs past its chunk's target
  and ``failed`` included, with one host read a try;
- against the JAX package's jitted jobs, the bars of
  tests/test_torch_mapmaker.py: the integration phases and the epipolar
  job through ``utils/parity.py`` (every difference traced to float
  noise, at most 1%, new points within 1e-3), re-find spans, local-BA
  masks, extraction, GC exactly, the BA write-back and the scheduler at
  the BA bars, the plane alignment fed JAX's uniforms within 1e-5; the
  chunk at tests/test_torch_bundle.py's ``compute`` bars;
- a conditional body's launches and calls are counted as often as it
  ran, and
  re-finding one keyframe launches K2 twice, as the eager calls do;
- what leaves a program survives the next call; no program function
  reads the device on the host or copies a host value to it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bundle as tb
import test_torch_mapmaker as tmm
from test_torch_initializer import _tilted_plane
from test_torch_mapmaker import ba_scene, sched_scene, scene  # noqa: F401
from test_torch_programs import _HostTraffic
from ptam_cg_tpu.config import BundleConfig
from ptam_cg_tpu.models import bundle as jbundle
from ptam_cg_tpu.models import mapmaker as jmapmaker
from ptam_cg_tpu.utils import mest as jmest
from ptam_cg_tpu_torch import config as tconfig
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.kernels import gather as kgather
from ptam_cg_tpu_torch.models import bundle as tbundle
from ptam_cg_tpu_torch.models import engine as tengine
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.models import map_state as tms
from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
from ptam_cg_tpu_torch.utils import parity

torch.set_num_threads(2)

SIZE, P, WIGGLE, THIN = tmm.SIZE, tmm.P, tmm.WIGGLE, tmm.THIN
CFG = BundleConfig()
FIELDS = [f.name for f in dataclasses.fields(tms.MapState)]


class _Emulated:
    """``graphs.Graph`` on the CPU: the warm-up on clones of the inputs,
    then each replay runs the function on its capture's path
    (``graphs.emulate``) and copies the outputs into the first replay's,
    as a graph's outputs are overwritten."""

    def __init__(self, fn, inputs, debug_path=None, pool=None):
        with graphs.warm():
            fn(*graphs.clone(inputs))
        self.fn, self.inputs, self.outputs = fn, inputs, None
        self.capture_s, self.launches, self.n_if = 0.0, {}, 0

    def replay(self, name=None):
        with graphs.emulate():
            out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        for buf, x in zip(graphs.tree.tensors(self.outputs),
                          graphs.tree.tensors(out)):
            if buf is not x:
                buf.copy_(x)
        return self.outputs


@pytest.fixture
def emulated(monkeypatch):
    """Programs asked for as graphs take the graph path on the CPU."""
    monkeypatch.setattr(graphs, "Graph", _Emulated)
    monkeypatch.setattr(graphs, "on_card", lambda device, flag: flag)


def _maps_equal(a, b, fields=FIELDS):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _scene_inputs(scene):
    mt = {k: fj.tensor(v, "cpu") for k, v in scene["meas"].items()}
    ff = fj.frame_features_from_numpy(fj.as_numpy_tree(scene["ff2"]), "cpu")
    pose = fj.se3_from_numpy(fj.as_numpy_tree(scene["pose2"]), "cpu")
    cam = fj.camera_from_numpy(fj.as_numpy_tree(scene["seq"].cam), "cpu")

    def fresh():
        return fj.map_state_from_numpy(fj.as_numpy_tree(scene["m"]), "cpu")
    return mt, ff, pose, cam, fresh


def _phased(maker, ff, pose, mt):
    """The integration a phase at a time: the map and new-point mask after
    each of the five phases, then the landed slot."""
    maker.add_keyframe(ff, pose, mt, torch.tensor(1.5), torch.tensor(0.1))
    maker._integrate_start()
    out = [(tms.copy_map(maker.map), maker.new_point_mask.clone())]
    while maker._integrate_job is not None:
        maker._integrate_advance()
        out.append((tms.copy_map(maker.map), maker.new_point_mask.clone()))
    return out, maker._drain_integrate(block=True)


def test_integration_programs_match_eager_and_jax(scene, monkeypatch):
    """The insert and the four epipolar levels: the emulated graphs equal
    the eager programs and the fused function bit for bit after every
    phase; each phase against the JAX MapMaker's jitted phase."""
    mt, ff, pose, cam, fresh = _scene_inputs(scene)
    diag = {}
    fused, fmask, fsn = tmapmaker.integrate_keyframe_program(
        fresh(), ff, pose, mt["point"], mt["pos"], mt["level"],
        mt["subpix"], mt["valid"], torch.tensor(1.5), torch.tensor(0.1),
        torch.zeros(P, dtype=torch.bool), cam, SIZE, WIGGLE, THIN, diag=diag)
    eager, eslot = _phased(tmapmaker.MapMaker(fresh(), cam, SIZE,
                                              graphs=False), ff, pose, mt)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "Graph", _Emulated)
        mp.setattr(graphs, "on_card", lambda device, flag: flag)
        maker = tmapmaker.MapMaker(fresh(), cam, SIZE)
        emul, gslot = _phased(maker, ff, pose, mt)
    assert sorted(maker.programs.jobs) == ["epi_l0", "epi_l1", "epi_l2",
                                           "epi_l3", "insert"]
    assert eslot == gslot == int(fsn[0]) == 1
    for (em, ek), (gm, gk) in zip(eager, emul):
        _maps_equal(em, gm)
        assert torch.equal(ek, gk)
    _maps_equal(emul[-1][0], fused)
    assert torch.equal(emul[-1][1], fmask)
    # Each phase against the JAX MapMaker's (its jitted programs).
    jm = jmapmaker.MapMaker(scene["m"], scene["seq"].cam, SIZE, seed=0)
    jm.add_keyframe(scene["ff2"], scene["pose2"], scene["meas"],
                    jnp.float32(1.5), jnp.float32(0.1))
    jm._integrate_start()
    before = np.asarray(scene["m"].point_valid)
    n_added = 0
    for ph, (gm, _) in enumerate(emul):
        if ph:
            jm._integrate_advance()
        ref = fj.as_numpy_tree(jm.map)
        diffs, counts = parity.integration_differences(
            {f: ref[f] for f in tmm.CMP_FIELDS},
            {f: getattr(gm, f) for f in tmm.CMP_FIELDS}, before, 1, diag,
            THIN, tmm.POS_TOL)
        n_added = sum(counts["added"].values())
        assert all(d["reason"] for d in diffs), (ph, diffs)
        assert len(diffs) <= 0.01 * (counts["refound"] + n_added), diffs
    assert counts["refound"] > 20 and n_added > 20, counts


def _refind_maps():
    tm, tcam = tsynth.ba_map(n_kfs=20, max_kfs=20, n_pts=96, seed=1,
                             image_size=tmm.BA_SIZE, device="cpu")
    valid = np.zeros(20, bool)
    valid[[0, 2, 3, 5, 7, 9, 12, 14, 17, 19]] = True
    tm.kf_valid = torch.from_numpy(valid)
    mask2d = np.random.default_rng(2).uniform(size=(20, 96)) < 0.3
    mask2d[[2, 12]] = False
    return tm, tcam, mask2d


class _Counts:
    """Calls of ``refind_in_kf`` (by slot) and K2 launches of their plain
    versions on the CPU (a pair entry counts once, as its kernel does)."""

    def __init__(self, monkeypatch):
        self.slots, self.k2, inner = [], 0, [False]
        refind = tmapmaker.refind_in_kf
        single = kgather.gather_windows_plain
        pair = kgather.gather_window_pair_plain

        # A warm-up's calls are not a replay's.
        def counted_refind(m, k, *a, **kw):
            if not graphs.warming():
                self.slots.append(int(k))
            return refind(m, k, *a, **kw)

        def counted_single(*a, **kw):
            self.k2 += not (inner[0] or graphs.warming())
            return single(*a, **kw)

        def counted_pair(*a, **kw):
            self.k2 += not graphs.warming()
            inner[0] = True
            try:
                return pair(*a, **kw)
            finally:
                inner[0] = False

        monkeypatch.setattr(tmapmaker, "refind_in_kf", counted_refind)
        monkeypatch.setattr(kgather, "gather_windows_plain", counted_single)
        monkeypatch.setattr(kgather, "gather_window_pair_plain",
                            counted_pair)


def test_refind_programs_match_eager_and_jax(emulated, monkeypatch):
    """The scheduler's two spans over 20 slots ([0, 16), then [4, 20)) and
    a whole re-find (one program of width 20) as emulated graphs: each
    slot's re-find runs exactly for the keyframes with work, as the JAX
    scan's ``lax.cond`` and the eager program run them, with 2 K2
    launches each; the maps equal the eager programs' bit for bit and
    JAX's exactly (the atlases are empty: every search fails, and the
    result is the never-retry marks)."""
    tm, tcam, mask2d = _refind_maps()
    jcam = jmapmaker.atan.make_camera(*tsynth.BA_CAMERA)
    counts = _Counts(monkeypatch)
    mk = torch.from_numpy(mask2d)
    eager = tmapmaker.MapMaker(tms.copy_map(tm), tcam, tmm.BA_SIZE,
                               graphs=False)
    maker = tmapmaker.MapMaker(tms.copy_map(tm), tcam, tmm.BA_SIZE)
    assert maker.programs.graphs and not eager.programs.graphs
    jm = tmm._to_jax(tm)
    for mm in (eager, maker):
        mm._start_refind_task(mk)
    for span in maker._span_ks:
        ref = fj.as_numpy_tree(jm)
        work = ref["kf_valid"] & np.any(
            mask2d & ref["point_valid"] & ~ref["meas_valid"]
            & ~ref["never_retry"], axis=-1)
        want = [k for k in span if work[k]]
        jm, _ = jmapmaker.refind_all_kfs(jm, jnp.asarray(mask2d), jcam,
                                         tmm.BA_SIZE,
                                         jnp.arange(span.start, span.stop))
        for mm in (eager, maker):
            counts.slots.clear()
            counts.k2 = 0
            mm._refind_advance()
            assert counts.slots == want and counts.k2 == 2 * len(want)
        _maps_equal(eager.map, maker.map)
        tmm._assert_maps_equal(jm, maker.map, ("meas_valid", "never_retry"))
    assert maker._refind_task is None and counts.slots == [17, 19]
    # The whole re-find: one width-20 program from slot 0.
    jall = jmapmaker.refind_all_kfs(tmm._to_jax(tm), jnp.asarray(mask2d),
                                    jcam, tmm.BA_SIZE)[0]
    whole = tmapmaker.MapMaker(tms.copy_map(tm), tcam, tmm.BA_SIZE)
    p = whole._load()
    p.refind.copy_(mk)
    total = whole._job("refind_w20", tmapmaker._refind_fn(
        20, tcam, tmm.BA_SIZE), (p.map, p.refind, p.k0))
    eager_all, eager_total = tmapmaker.refind_all_kfs(
        tms.copy_map(tm), mk, tcam, tmm.BA_SIZE)
    _maps_equal(whole.map, eager_all)
    assert int(total) == int(eager_total)
    tmm._assert_maps_equal(jall, whole.map, ("meas_valid", "never_retry"))


def test_epipolar_job_program_matches_eager_and_jax(scene, emulated):
    """``add_some_map_points`` (one epipolar level against the closest
    keyframe) on the integrated 2-keyframe map, from keyframe 1 at levels
    0 and 3: the emulated graph equals the eager job bit for bit, and JAX's
    jitted job at the integration's bars."""
    mt, ff, pose, cam, fresh = _scene_inputs(scene)
    jm0, _, _ = tmm._jax_integrate(scene)
    base = fj.map_state_from_numpy(fj.as_numpy_tree(jm0), "cpu")
    jmk = jmapmaker.MapMaker(jm0, scene["seq"].cam, SIZE, seed=0)
    maker = tmapmaker.MapMaker(tms.copy_map(base), cam, SIZE)
    m = tms.copy_map(base)
    npm = torch.zeros(P, dtype=torch.bool)
    before = np.asarray(jm0.point_valid)
    for lev in (0, 3):
        d = {}
        m, n, npm = tmapmaker.epipolar_job(m, 1, npm, lev, cam, SIZE, WIGGLE,
                                           THIN, diag=d)
        assert maker.add_some_map_points(1, lev) == int(n)
        _maps_equal(maker.map, m)
        assert torch.equal(maker.new_point_mask, npm)
        jn = jmk.add_some_map_points(1, lev)
        ref = fj.as_numpy_tree(jmk.map)
        diffs, counts = parity.integration_differences(
            {f: ref[f] for f in tmm.CMP_FIELDS},
            {f: getattr(m, f) for f in tmm.CMP_FIELDS}, before, 1,
            {"refind": {}, lev: d}, THIN, tmm.POS_TOL)
        assert all(dd["reason"] for dd in diffs), diffs
        assert len(diffs) <= 0.01 * max(jn, 1) + 1, diffs
        assert counts["added"].get(lev, 0) == jn or diffs
        before = ref["point_valid"]
    assert sorted(maker.programs.jobs) == ["epipolar_l0", "epipolar_l3"]


def test_ba_programs_match_eager_and_jax(ba_scene, emulated):
    """Local BA of keyframe 9 and then global BA through emulated graphs:
    the masks and the extraction at the tier equal JAX's exactly; the
    chunks, the write-back and GC equal the eager MapMaker's bit for bit,
    and the JAX MapMaker's at the BA bars."""
    tm, tcam, jcam = ba_scene
    hint = int(tm.point_valid.sum())
    jmk = jmapmaker.MapMaker(tmm._to_jax(tm), jcam, tmm.BA_SIZE)
    eager = tmapmaker.MapMaker(tms.copy_map(tm), tcam, tmm.BA_SIZE,
                               graphs=False)
    maker = tmapmaker.MapMaker(tms.copy_map(tm), tcam, tmm.BA_SIZE)
    for mk in (jmk, eager, maker):
        mk._n_points_hint = hint
    maker.bundle_adjust_recent(9, start_only=True)
    p, job = maker.programs, maker._ba_job
    ja, jf, jp = jmapmaker.local_ba_masks(tmm._to_jax(tm), 9)
    for got, want in ((p.adjust, ja), (p.fixed, jf), (p.pmask, jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    caps = job["caps"]
    jprob, jk, jpi, jci, jpt, jc = jmapmaker.extract_bundle_compact(
        tmm._to_jax(tm), ja, jf, jp, *caps)
    tier = job["tier"]
    tmm._assert_problems_equal(jprob, tier.prob)
    for got, want in ((tier.mk, jk), (tier.mp, jpi), (tier.cam_idx, jci),
                      (tier.pt_idx, jpt), (tier.counts, jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    while maker._ba_job is not None:
        maker._ba_poll(block=True)
    assert list(p.chunks) and all(
        prog.graphs for prog in p.chunks.values())
    eager.bundle_adjust_recent(9)
    jmk.bundle_adjust_recent(9)
    for mk in (jmk, eager, maker):
        mk.bundle_adjust_all()
        mk.mark_dirty()
        mk.handle_bad_points()
    assert not maker.reset_requested and not jmk.reset_requested
    _maps_equal(eager.map, maker.map)
    assert torch.equal(eager.failure_mask, maker.failure_mask)
    assert (maker.converged_full, maker.converged_recent) == (
        eager.converged_full, eager.converged_recent) == (
        jmk.converged_full, jmk.converged_recent)
    np.testing.assert_array_equal(maker.failure_mask.numpy(),
                                  np.asarray(jmk.failure_mask))
    tmm._assert_maps_equal(jmk.map, maker.map,
                           ("point_valid", "meas_valid", "never_retry"))
    ref = fj.as_numpy_tree(jmk.map)
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("point_pos", 1e-3)):
        np.testing.assert_allclose(getattr(maker.map, f).numpy(), ref[f],
                                   rtol=0, atol=tol, err_msg=f)
    assert {"local_masks", "gc"} <= set(p.jobs)
    assert any(k.startswith("apply_") for k in p.jobs)


@pytest.mark.parametrize("first,then", [(6, 20), (20, 7)],
                         ids=["raised", "lowered"])
def test_ba_config_replaced_mid_run_matches_eager(ba_scene, emulated, first,
                                                  then):
    """The console replacing ``ba_cfg.max_iterations`` between two chunks
    of a global BA (``Bundle.MaxIterations``): the emulated graphs run each
    chunk with the config in force, as the eager MapMaker does, so the run
    neither outgrows the first chunk graph's slots nor keeps its retry
    bound, and the map, the failure mask and the flags equal the eager
    run's bit for bit."""
    tm, tcam, _ = ba_scene
    hint = int(tm.point_valid.sum())
    makers, flags = [], []
    for on in (False, True):
        mk = tmapmaker.MapMaker(
            tms.copy_map(tm), tcam, tmm.BA_SIZE, graphs=on,
            ba_cfg=tconfig.BundleConfig(max_iterations=first))
        mk._n_points_hint = hint
        mk.bundle_adjust_all(start_only=True)
        mk._ba_poll(block=True)             # the first chunk
        first_flags = mk._ba_job["flags"]
        mk.ba_cfg = dataclasses.replace(mk.ba_cfg, max_iterations=then)
        while mk._ba_job is not None:
            flags.append(mk._ba_job["flags"])
            mk._ba_poll(block=True)
        makers.append(mk)
        assert not first_flags[0] and first_flags[1] == 5, first_flags
    eager, maker = makers
    assert flags[:len(flags) // 2] == flags[len(flags) // 2:]
    assert len(maker.programs.chunks) == 2
    assert not maker.reset_requested and not eager.reset_requested
    _maps_equal(eager.map, maker.map)
    assert torch.equal(eager.failure_mask, maker.failure_mask)
    assert (maker.converged_full, maker.converged_recent) == (
        eager.converged_full, eager.converged_recent)


def test_plane_align_program_matches_eager_and_jax(emulated):
    """``plane_align`` fed JAX's uniforms (the key's draw): the emulated
    graph equals the eager one bit for bit and JAX's jitted program within
    1e-5."""
    jm, tm = _tilted_plane()
    cam = tmm._ba_cam()
    key = jax.random.PRNGKey(1)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (100, 256))))
    eager = tmapmaker.MapMaker(tms.copy_map(tm), cam, tmm.BA_SIZE,
                               graphs=False)
    maker = tmapmaker.MapMaker(tms.copy_map(tm), cam, tmm.BA_SIZE)
    for mk in (eager, maker):
        mk.plane_align(u)
    _maps_equal(eager.map, maker.map)
    jmk = jmapmaker.MapMaker(jm, jmapmaker.atan.make_camera(
        (1.0, 1.0, 0.5, 0.5, 0.1), tmm.BA_SIZE), tmm.BA_SIZE)
    ref = fj.as_numpy_tree(jmk._jit_plane_align(jm, key))
    for f in ("kf_R", "kf_t", "point_pos", "point_right_w", "point_down_w"):
        np.testing.assert_allclose(getattr(maker.map, f).numpy(), ref[f],
                                   atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# BA's LM chunk
# ---------------------------------------------------------------------------

def _chunk_problem(case):
    """(problem, camera) of a chunk case: ``ba_problem``'s 5 cameras (0
    and 2 fixed), 128 points, 512 measurements, seed 25: 5 accepted steps
    and a converging one make 7 tries, and JAX's runs take the same tries
    in every chunking (near convergence whether a try lowers the error is
    float noise, and on most seeds the packages part there; the CPU port
    on 2 threads); "failed" with every measurement's inverse noise at
    1e18, so that the normal equations overflow
    (tests/test_torch_bundle.py's blown solve)."""
    prob, cam = tsynth.ba_problem(5, 128, 512, seed=25, fixed=(0, 2),
                                  device="cpu")
    if case == "failed":
        prob = dataclasses.replace(prob, meas_sqrt_inv_noise=torch.where(
            prob.meas_valid, 1e18, prob.meas_sqrt_inv_noise))
    return prob, cam


def _steps_loop(state, cam, limit, f):
    """The chunk as a host loop of ``lm_step_flags`` (the port before its
    try slots)."""
    while True:
        conv, iters, failed, _ = f
        if conv or failed or iters >= limit:
            return state, f
        state, f = tbundle.lm_step_flags(state, cam, CFG, jmest.TUKEY)


def _states_equal(a, b):
    for x, y in zip(tbundle._state_tensors(a), tbundle._state_tensors(b)):
        assert torch.equal(x, y)


def _to_jax_state(state):
    prob = jbundle.BundleProblem(**{
        f.name: jnp.asarray(getattr(state.problem, f.name).numpy())
        for f in dataclasses.fields(state.problem)})
    return jbundle.init_lm(prob)


#: Chunk targets a case runs, each ``None`` for "iterations so far + 1"
#: (JAX's step-flags program), an int for a fixed limit.
CHUNKS = {"one_step": [None] * 8, "plus5": [5, 10, 15],
          "full": [20], "failed": [5, 20]}


@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_lm_chunk_slots_match_steps_and_jax(case, emulated):
    """The chunk's try slots eagerly, through an emulated
    ``ChunkProgram``, and as the host loop of steps: the same state bit
    for bit and the same flags after every chunk, one host read a try eagerly;
    JAX's ``_cached_lm_chunk`` (``_cached_lm_step_flags`` for one step) at the
    ``compute`` bars."""
    prob, cam = _chunk_problem(case)
    start = tbundle.init_lm(prob, CFG)
    prog = tbundle.ChunkProgram(start, cam, CFG, jmest.TUKEY)
    assert prog.graphs
    jcam = jbundle.atan.make_camera(*tsynth.BA_CAMERA)
    jchunk = jbundle._cached_lm_chunk(CFG, jmest.TUKEY)
    loop = slots = emul = start
    fl = fs = fe = tbundle.INIT_FLAGS
    jstate = _to_jax_state(start)
    steps, orig = [0], tbundle._step_parts

    def counted(*a, **kw):
        steps[0] += 1
        return orig(*a, **kw)

    overran = retried = False
    for target in CHUNKS[case]:
        limit = fl[1] + 1 if target is None else target
        if fl[0] or fl[2] or fl[1] >= limit:
            break
        iters0 = fl[1]
        loop, fl = _steps_loop(loop, cam, limit, fl)
        steps[0] = 0
        tbundle._step_parts = counted
        try:
            with _HostTraffic() as seen:
                slots, fs = tbundle.lm_chunk(slots, cam, CFG, jmest.TUKEY,
                                             limit, fs)
        finally:
            tbundle._step_parts = orig
        emul, fe = prog(emul, limit, fe)
        assert fl == fs == fe, (target, fl, fs, fe)
        _states_equal(loop, slots)
        _states_equal(loop, emul)
        tries = fs[1] - iters0
        assert seen.calls.count("tolist") == tries
        retried |= tries > steps[0]
        overran |= fs[1] > limit
        jstate, jflags = jchunk(jstate, jcam, jnp.int32(limit))
        tb.assert_states_close(jstate, slots, 1e-4, 1e-3, 1e-3)
    assert emul is prog.state
    if case == "failed":
        assert fs[2] == 1 and bool(slots.failed)
    else:
        assert retried and fs[2] == 0
    if case == "one_step":
        assert overran


def test_chunk_program_returns_its_buffers():
    """A ``ChunkProgram`` call returns its state buffers, which the next
    call overwrites (a caller clones what it keeps); a chunk that has
    nothing to run returns what it was given, with no device work."""
    prob, cam = _chunk_problem("plus5")
    start = tbundle.init_lm(prob, CFG)
    prog = tbundle.ChunkProgram(start, cam, CFG, jmest.TUKEY)
    s1, f1 = prog(start, 1, tbundle.INIT_FLAGS)
    assert s1 is prog.state
    kept = tbundle.LMState(**{
        f.name: graphs.clone(getattr(s1, f.name))
        for f in dataclasses.fields(s1)})
    s2, f2 = prog(s1, 3, f1)
    assert s2 is s1 and f2[1] > f1[1]
    assert not torch.equal(kept.problem.pt_pos, s2.problem.pt_pos)
    s3, f3 = prog(kept, 3, (1, f1[1], 0, f1[3]))
    assert s3 is kept and f3 == (1, f1[1], 0, f1[3])
    with pytest.raises(ValueError):        # more tries than slots
        prog(s2, CFG.max_iterations + 1, (0, f2[1], 0, f2[3]))
    assert start.problem.pt_pos.data_ptr() != s1.problem.pt_pos.data_ptr()


# ---------------------------------------------------------------------------
# The scheduler, what escapes, the counts, the scan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated_scheduler(sched_scene):
    """The 8-keyframe scheduler run (tests/test_torch_mapmaker.py) through
    a MapMaker whose programs run as emulated graphs: (maker, log, jobs)."""
    seq, m, kfs = sched_scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "Graph", _Emulated)
        mp.setattr(graphs, "on_card", lambda device, flag: flag)
        maker = tmapmaker.MapMaker(
            fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"),
            fj.camera_from_numpy(fj.as_numpy_tree(seq.cam), "cpu"), SIZE,
            seed=0)
        maker._n_points_hint = int(m.point_valid.sum())
        maker.capture_jobs()                # as the engine's init does
        log, jobs = tmm._run_scheduler(maker, kfs, True)
    return maker, log, jobs


def test_scheduler_programs_match_eager_and_jax(sched_scene,
                                                emulated_scheduler):
    """tests/test_torch_mapmaker.py's scheduler test with the MapMaker's
    programs as emulated graphs: every pass's return and flags and the
    jobs equal ``MapMaker(graphs=False)``'s and the JAX MapMaker's; the
    map and failure mask equal the eager run's bit for bit and JAX's at
    the BA bars."""
    seq, m, kfs = sched_scene
    maker, log, jobs = emulated_scheduler
    eager = tmapmaker.MapMaker(
        fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"),
        fj.camera_from_numpy(fj.as_numpy_tree(seq.cam), "cpu"), SIZE, seed=0,
        graphs=False)
    eager._n_points_hint = int(m.point_valid.sum())
    elog, ejobs = tmm._run_scheduler(eager, kfs, True)
    jmaker = jmapmaker.MapMaker(m, seq.cam, SIZE, seed=0)
    jmaker._n_points_hint = int(m.point_valid.sum())
    jlog, jjobs = tmm._run_scheduler(jmaker, kfs, False)
    assert log == elog == jlog
    assert jobs == ejobs == jjobs
    assert all(n > 0 for n in jobs.values()), jobs
    _maps_equal(maker.map, eager.map)
    assert torch.equal(maker.failure_mask, eager.failure_mask)
    progs = maker.programs
    assert progs.graphs and progs.chunks and not eager.programs.graphs
    tmm._assert_maps_equal(jmaker.map, maker.map,
                           ("point_valid", "meas_valid", "never_retry",
                            "kf_valid"))
    ref = fj.as_numpy_tree(jmaker.map)
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("point_pos", 1e-3)):
        np.testing.assert_allclose(getattr(maker.map, f).numpy(), ref[f],
                                   rtol=0, atol=tol, err_msg=f)


def test_map_programs_neither_read_nor_copy_from_the_host(
        emulated_scheduler, scene, emulated):
    """tests/test_torch_programs.py's scan over every MapMaker program the
    scheduler ran (insert, epipolar levels, span re-find, local masks,
    extraction, write-back, GC, the LM chunks), the epipolar job and the
    plane alignment, each run as its warm-up runs it (every conditional
    body once, no predicate read)."""
    maker = emulated_scheduler[0]
    mt, ff, pose, cam, fresh = _scene_inputs(scene)
    other = tmapmaker.MapMaker(fresh(), cam, SIZE)
    other.add_some_map_points(0, 1)
    other.plane_align(torch.rand(100, P))
    jobs = dict(maker.programs.jobs, **other.programs.jobs)
    assert {"insert", "epi_l3", "epi_l2", "refind_w16", "local_masks", "gc",
            "epipolar_l1", "plane_align"} <= set(jobs)
    runs = [(label, job.fn, job.inputs) for label, job in jobs.items()]
    runs += [(prog.label, prog._fn, prog._inputs())
             for prog in maker.programs.chunks.values()]
    for label, fn, inputs in runs:
        with graphs.warm(), _HostTraffic() as seen:
            fn(*graphs.clone(inputs))
        assert seen.calls == [], (label, seen.calls)


def test_capture_jobs_leaves_the_map(scene, emulated):
    """``MapMaker.capture_jobs`` captures the jobs of fixed shapes (the
    four integration levels, the span re-finds, local masks, GC) and runs
    nothing on the map; with ``graphs=False`` it captures nothing."""
    mt, ff, pose, cam, fresh = _scene_inputs(scene)
    maker = tmapmaker.MapMaker(fresh(), cam, SIZE)
    keep = tms.copy_map(maker.map)
    maker.capture_jobs()
    widths = {f"refind_w{len(ks)}" for ks in maker._span_ks}
    want = {"epi_l0", "epi_l1", "epi_l2", "epi_l3", "local_masks",
            "gc"} | widths
    assert set(maker.programs.jobs) == want
    assert sorted(lb for lb, _ in maker.programs.captures) == sorted(want)
    _maps_equal(maker.programs.map, keep)
    maker.capture_jobs()                    # captured once
    assert len(maker.programs.captures) == len(want)
    eager = tmapmaker.MapMaker(fresh(), cam, SIZE, graphs=False)
    eager.capture_jobs()
    assert not eager.programs.jobs


def test_what_leaves_a_program_survives_the_next_call(ba_scene, emulated):
    """The caller's map is never written by the MapMaker's jobs; its
    ``map`` is the programs' buffers, which the next job writes; a
    synchronous engine's ``snapshot()`` is a copy no job writes; a BA
    chunk writes only its own buffers."""
    tm, tcam, _ = ba_scene
    keep = tms.copy_map(tm)
    maker = tmapmaker.MapMaker(tm, tcam, tmm.BA_SIZE)
    maker._n_points_hint = int(tm.point_valid.sum())
    maker.bundle_adjust_all(start_only=True)
    maker._ba_poll(block=True)              # the first chunk
    assert maker.map is tm                  # no write-back yet
    maker.kf_queue.append("keyframe")       # aborts after the chunk
    maker._ba_poll(block=True)
    maker.kf_queue.clear()
    _maps_equal(tm, keep)
    bufs = maker.map
    assert bufs is maker.programs.map and bufs is not tm
    after_ba = tms.copy_map(bufs)
    maker.plane_align(torch.rand(100, tm.point_pos.shape[0]))
    assert maker.map is bufs
    assert not torch.equal(bufs.point_pos, after_ba.point_pos)
    _maps_equal(tm, keep)
    # The engine's snapshot.
    cfg = tconfig.EngineConfig()
    eng = tengine.SLAMEngine(cfg, image_size=tmm.BA_SIZE, max_points=256,
                             max_kfs=16, device="cpu", auto_init_frames=None)
    eng.mapmaker.cam = tcam
    eng.mapmaker.map = tms.copy_map(tm)
    eng.mapmaker.plane_align(torch.rand(100, 256))
    eng.map = eng.mapmaker.map
    snap = eng.snapshot()
    snap_keep = tms.copy_map(snap)
    eng.mapmaker.plane_align(torch.rand(100, 256))
    assert eng.map is eng.mapmaker.map
    assert not torch.equal(eng.map.point_pos, snap_keep.point_pos)
    _maps_equal(snap, snap_keep)


def test_if_body_counts_what_ran():
    """A capture records each ``note_call`` (and launch) in the tally of
    the conditional body it is in; ``Graph.settle`` adds a body's counts times
    the runs its counter gained since the last settle, on the stream and thread
    of the graph's replays."""
    with _build.tally() as outside:
        graphs.note_call("refind_in_kf")
    assert outside == {}                    # not capturing: no record
    with _build.tally() as inside, graphs._flag("capturing"):
        graphs.note_call("refind_in_kf")
        _build.count_launch(kgather, 0)
    assert inside == {"refind_in_kf": 1, kgather: 1}
    g = graphs.Graph.__new__(graphs.Graph)
    g.device = torch.device("cpu")
    g.bodies = [{kgather: 2, "refind_in_kf": 1}, {"add_points_epipolar": 1}]
    g.body_runs = torch.tensor([3, 0])
    g._settled, g._where = [1, 0], (77, "mapping")
    k2 = kgather.launches
    by_stream = kgather.launches_by_stream.get(77, 0)
    calls = graphs.replays.get("refind_in_kf", 0)
    mapping = graphs.replays_by_thread.get("mapping", {}).get(
        "refind_in_kf", 0)
    g.settle()
    assert kgather.launches - k2 == 4
    assert kgather.launches_by_stream[77] - by_stream == 4
    assert graphs.replays["refind_in_kf"] - calls == 2
    assert graphs.replays_by_thread["mapping"]["refind_in_kf"] - mapping == 2
    g.settle()                              # nothing new ran
    assert kgather.launches - k2 == 4 and g._settled == [3, 0]
