"""Bundle adjustment: the PyTorch port against the JAX package.

The problems are ``tests/test_bundle.py::make_problem``'s (4 cameras on an
arc, 64 points around z = 4, at most 512 measurements) and
``bench_ba.make_problem``'s (random camera-point pairs, some repeated),
built with numpy from a seed and handed to both packages. Tolerances:

- ``lm_step``: the same iterations, accepted steps, lambda and pruned set;
  poses within 1e-5, points within 1e-4 (float32 solves of the same
  normal equations, summed in another order); the robust error within a
  relative 1e-3: a Tukey weight near its cut-off amplifies a residual's
  float32 noise (a 1e-5 point difference moves a 0.5 px residual by
  ~1e-3 px).
- ``compute``: the same flags and pruned set; error relative 1e-3;
  points within 1e-3. On the step that converges, the accept test
  compares two errors that differ by float noise alone (under a relative
  1e-6), so whether it counts as accepted is a coin toss between the
  packages; the cases are seeds on which it does not flip (with Huber's
  estimator it flips on seed 2 of make_problem's noisy problem).
- the accumulators: within 1e-4 of each block's largest entry.
The JAX side runs at float32 matmul precision (tests/conftest.py pins
"highest").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_ba
from test_bundle import make_problem
from ptam_cg_tpu.config import BundleConfig
from ptam_cg_tpu.models import bundle as jbundle
from ptam_cg_tpu.utils import mest as jmest
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.models import bundle as tbundle
from ptam_cg_tpu_torch.utils import mest as tmest

torch.set_num_threads(2)

CFG = BundleConfig()
LEAN = dataclasses.replace(CFG, soff_tiles=8, u_chunks=8)

#: lm_step / compute cases: make_problem keywords and the estimator.
CASES = {
    "perturbed": (dict(seed=11, noise_px=0.3, perturb_cams=0.02,
                       perturb_pts=0.05), jmest.TUKEY),
    "outliers": (dict(seed=4, noise_px=0.3, perturb_pts=0.02, outliers=12),
                 jmest.TUKEY),
    "noisy_huber": (dict(seed=5, noise_px=0.5, perturb_cams=0.01,
                         perturb_pts=0.03), jmest.HUBER),
}


def port(prob, cam):
    return (fj.bundle_problem_from_numpy(fj.as_numpy_tree(prob), "cpu"),
            fj.camera_from_numpy(fj.as_numpy_tree(cam), "cpu"))


def np_(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_states_close(js, ts, pose_tol, pt_tol, err_rtol):
    assert int(js.iters) == int(ts.iters)
    assert int(js.accepted) == int(ts.accepted)
    assert bool(js.converged) == bool(ts.converged)
    assert bool(js.failed) == bool(ts.failed)
    np.testing.assert_array_equal(np_(ts.problem.meas_bad),
                                  np_(js.problem.meas_bad))
    for f in ("cam_R", "cam_t"):
        np.testing.assert_allclose(np_(getattr(ts.problem, f)),
                                   np_(getattr(js.problem, f)), rtol=0,
                                   atol=pose_tol, err_msg=f)
    np.testing.assert_allclose(np_(ts.problem.pt_pos), np_(js.problem.pt_pos),
                               rtol=0, atol=pt_tol)
    np.testing.assert_allclose(float(ts.last_error), float(js.last_error),
                               rtol=err_rtol, atol=1e-6)


@pytest.mark.parametrize("kind", [jmest.TUKEY, jmest.CAUCHY, jmest.HUBER,
                                  jmest.LSQ])
def test_sqrt_weight_and_objective_match_jax(kind):
    rng = np.random.default_rng(kind)
    err = rng.uniform(0, 4, 257).astype(np.float32)
    err[:3] = [0.0, 1.7, 1.7000001]          # at and around sigma^2
    sig = np.float32(1.7)
    for name in ("sqrt_weight", "objective"):
        want = np.asarray(getattr(jmest, name)(jnp.asarray(err), sig, kind))
        got = getattr(tmest, name)(torch.from_numpy(err), torch.tensor(sig),
                                   kind).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_matches_jax(case):
    kw, kind = CASES[case]
    prob, cam, _, _ = make_problem(**kw)
    tprob, tcam = port(prob, cam)
    step = jax.jit(lambda s: jbundle.lm_step(s, cam, CFG, kind))
    js, ts = jbundle.init_lm(prob, CFG), tbundle.init_lm(tprob, CFG)
    for _ in range(4):
        js, ts = step(js), tbundle.lm_step(ts, tcam, CFG, kind)
        assert_states_close(js, ts, 1e-5, 1e-4, 1e-3)
        np.testing.assert_allclose(float(ts.lam), float(js.lam), rtol=1e-6)
        np.testing.assert_allclose(float(ts.lam_factor),
                                   float(js.lam_factor), rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_compute_matches_jax(case):
    kw, kind = CASES[case]
    prob, cam, _, _ = make_problem(**kw)
    tprob, tcam = port(prob, cam)
    js, jn, jflags = jbundle.compute(prob, cam, CFG, kind, return_flags=True)
    ts, tn, tflags = tbundle.compute(tprob, tcam, CFG, kind,
                                     return_flags=True)
    assert (jn, jflags) == (tn, tflags)
    assert_states_close(js, ts, 1e-4, 1e-3, 1e-3)


@pytest.mark.parametrize("cfg", [CFG, LEAN], ids=["dense", "lean"])
def test_accumulators_match_jax_with_repeated_pairs(cfg):
    """bench_ba's problem repeats (camera, point) pairs: the port's slot
    layout must sum them as JAX's scatter-add does."""
    prob, cam = bench_ba.make_problem(6, 256, 1024, seed=5)
    tprob, tcam = port(prob, cam)
    lay = tbundle.measurement_layout(tprob)
    assert lay.n_pair > 1 and lay.n_pt > 1
    # A wide sigma (20 px) keeps the Tukey weights off their cut-off,
    # where float32 noise in a residual is amplified without bound.
    sigma_sq = np.float32(400.0)
    want = jbundle._accumulators(prob, cam, jnp.float32(sigma_sq), cfg, 0)
    got = tbundle._accumulators(tprob, lay, tcam, torch.tensor(sigma_sq),
                                cfg, 0)
    C = prob.cam_R.shape[0]
    w_want = np.asarray(want[4])
    w_want = w_want[None] if w_want.ndim == 2 else w_want
    pairs = [("U", want[0], got[0]), ("ea", want[1], got[1]),
             ("V", want[2], got[2]), ("eb", want[3], got[3]),
             ("W", w_want, got[4][:, :18 * C]), ("err", want[5], got[5])]
    for name, a, b in pairs:
        a, b = np.asarray(a), np_(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    for j, name in ((6, "new_bad"), (7, "good")):
        np.testing.assert_array_equal(np_(got[j]), np.asarray(want[j]), name)


def test_ba_problem_is_bench_ba_problem():
    prob, cam = bench_ba.make_problem(6, 256, 1024, seed=5)
    tprob, tcam = tsynth.ba_problem(6, 256, 1024, seed=5, device="cpu")
    ref = fj.as_numpy_tree(prob)
    for f in ref:
        np.testing.assert_allclose(np_(getattr(tprob, f)), ref[f], rtol=0,
                                   atol=2e-4 if f == "meas_pos" else 1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(tcam.params.numpy(), np.asarray(cam.params))


def test_lm_state_from_numpy_continues_a_jax_run():
    prob, cam, _, _ = make_problem(**CASES["perturbed"][0])
    js = jbundle.init_lm(prob, CFG)
    for _ in range(2):
        js = jbundle.lm_step(js, cam, CFG)
    ts = fj.lm_state_from_numpy(fj.as_numpy_tree(js), "cpu", CFG)
    assert int(ts.iters) == int(js.iters) and float(ts.lam) == float(js.lam)
    _, tcam = port(prob, cam)
    assert_states_close(jbundle.lm_step(js, cam, CFG),
                        tbundle.lm_step(ts, tcam, CFG), 1e-5, 1e-4, 1e-3)


def test_run_is_repeatable_bit_for_bit():
    tprob, tcam = tsynth.ba_problem(8, 512, 2048, seed=1, device="cpu")
    a, _ = tbundle.compute(tprob, tcam)
    b, _ = tbundle.compute(tprob, tcam)
    for f in ("cam_R", "cam_t", "pt_pos", "meas_bad"):
        assert torch.equal(getattr(a.problem, f), getattr(b.problem, f)), f
    assert torch.equal(a.last_error, b.last_error)
    assert float(tbundle.residual_rms(a.problem, tcam)) < float(
        tbundle.residual_rms(tprob, tcam))


# ---- the JAX package's tests/test_bundle.py, on the port ----

def test_perfect_data_stays_converged():
    prob, cam = port(*make_problem()[:2])
    state, _ = tbundle.compute(prob, cam)
    assert bool(state.converged)
    assert float(tbundle.residual_rms(state.problem, cam)) < 0.01


def test_recovers_perturbed_geometry():
    prob, cam, (R_gt, t_gt, pts_gt), _ = make_problem(
        seed=1, perturb_cams=0.02, perturb_pts=0.05)
    tprob, tcam = port(prob, cam)
    state, _ = tbundle.compute(tprob, tcam)
    assert float(tbundle.residual_rms(state.problem, tcam)) < 0.05
    for j in range(2, 4):
        dR = state.problem.cam_R[j].numpy() @ np.asarray(R_gt[j]).T
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 2e-3
        assert np.linalg.norm(state.problem.cam_t[j].numpy()
                              - np.asarray(t_gt[j])) < 5e-3
    err = np.linalg.norm(state.problem.pt_pos.numpy() - np.asarray(pts_gt),
                         axis=-1)
    assert np.median(err) < 5e-3


def test_noisy_converges_to_noise_floor():
    prob, cam = port(*make_problem(seed=2, noise_px=0.5, perturb_cams=0.01,
                                   perturb_pts=0.03)[:2])
    state, _ = tbundle.compute(prob, cam)
    assert 0.2 < float(tbundle.residual_rms(state.problem, cam)) < 1.0


def test_fixed_cameras_unchanged():
    prob, cam = port(*make_problem(seed=3, perturb_cams=0.02,
                                   perturb_pts=0.05)[:2])
    state, _ = tbundle.compute(prob, cam)
    assert torch.equal(state.problem.cam_R[:2], prob.cam_R[:2])
    assert torch.equal(state.problem.cam_t[:2], prob.cam_t[:2])


def test_prunes_gross_outliers():
    prob, cam, (_, _, pts_gt), out_idx = make_problem(
        seed=4, perturb_pts=0.02, outliers=12)
    tprob, tcam = port(prob, cam)
    state, _ = tbundle.compute(tprob, tcam)
    assert state.problem.meas_bad.numpy()[out_idx].mean() > 0.7
    err = np.linalg.norm(state.problem.pt_pos.numpy() - np.asarray(pts_gt),
                         axis=-1)
    assert np.median(err) < 0.01
    jstate, _ = jbundle.compute(prob, cam)
    np.testing.assert_array_equal(state.problem.meas_bad.numpy(),
                                  np.asarray(jstate.problem.meas_bad))


def test_respects_max_iterations():
    prob, cam = port(*make_problem(seed=5, perturb_cams=0.1,
                                   perturb_pts=0.2)[:2])
    state, _ = tbundle.compute(prob, cam, BundleConfig(max_iterations=3))
    assert int(state.iters) <= 3 + 1   # the lambda loop may overshoot by one


def test_abort_between_chunks():
    prob, cam = port(*make_problem(seed=6, perturb_cams=0.05,
                                   perturb_pts=0.1)[:2])
    state, n = tbundle.compute(prob, cam, abort_check=lambda: True)
    assert n == 1 and int(state.iters) <= 5     # one chunk of 5 steps


def test_nan_point_measurements_pruned_not_poisoning():
    prob, cam, _, _ = make_problem(perturb_cams=0.02, perturb_pts=0.02)
    pts = np.asarray(prob.pt_pos).copy()
    pts[3] = np.nan
    prob = prob._replace(pt_pos=jnp.asarray(pts))
    tprob, tcam = port(prob, cam)
    state, _ = tbundle.compute(tprob, tcam)
    assert not bool(state.failed)
    assert np.isfinite(float(state.last_error))
    poisoned = (tprob.meas_pt == 3) & tprob.meas_valid
    assert bool(state.problem.meas_bad[poisoned].all())
    out = state.problem.pt_pos.numpy()
    assert np.isfinite(out[np.arange(len(out)) != 3]).all()
    assert torch.isfinite(state.problem.cam_t).all()
    jstate, _ = jbundle.compute(prob, cam)
    np.testing.assert_array_equal(state.problem.meas_bad.numpy(),
                                  np.asarray(jstate.problem.meas_bad))


def test_blown_solve_sets_failed_flag():
    """Normal equations that overflow float32 in the solve make the
    Cholesky factorisation fail: ``failed`` is set, nothing raises."""
    prob, cam, _, _ = make_problem(perturb_cams=0.02, perturb_pts=0.02)
    noise = np.asarray(prob.meas_sqrt_inv_noise).copy()
    noise[np.asarray(prob.meas_valid)] = 1e18
    prob = prob._replace(meas_sqrt_inv_noise=jnp.asarray(noise))
    tprob, tcam = port(prob, cam)
    state, _, flags = tbundle.compute(tprob, tcam, return_flags=True)
    assert bool(state.failed) and flags[2]
    assert bool(jbundle.compute(prob, cam)[0].failed)


def test_lean_step_matches_dense():
    """``soff_tiles`` (a P-tiled Schur accumulation) and ``u_chunks`` (an
    M-chunked U) give the dense step's flags and pruned set, and poses and
    points within float32 reassociation."""
    prob, cam = port(*make_problem(seed=11, noise_px=0.3, perturb_cams=0.02,
                                   perturb_pts=0.02)[:2])
    assert tbundle.lean_tiles(LEAN, prob.pt_pos.shape[0]) == 8
    sd, sl = tbundle.init_lm(prob, CFG), tbundle.init_lm(prob, LEAN)
    for _ in range(4):
        sd = tbundle.lm_step(sd, cam, CFG)
        sl = tbundle.lm_step(sl, cam, LEAN)
    assert int(sd.iters) == int(sl.iters)
    assert int(sd.accepted) == int(sl.accepted)
    assert not bool(sd.failed) and not bool(sl.failed)
    for f in ("cam_t", "cam_R"):
        np.testing.assert_allclose(getattr(sl.problem, f).numpy(),
                                   getattr(sd.problem, f).numpy(), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(sl.problem.pt_pos.numpy(),
                               sd.problem.pt_pos.numpy(), rtol=0, atol=1e-4)
    assert torch.equal(sl.problem.meas_bad, sd.problem.meas_bad)


def test_lean_fallback_non_divisible_is_dense():
    prob, cam = port(*make_problem(seed=12, n_pts=63, cap_meas=509,
                                   perturb_pts=0.01)[:2])
    assert tbundle.lean_tiles(LEAN, prob.pt_pos.shape[0]) == 1
    sd = tbundle.lm_step(tbundle.init_lm(prob, CFG), cam, CFG)
    sl = tbundle.lm_step(tbundle.init_lm(prob, LEAN), cam, LEAN)
    assert torch.equal(sd.problem.pt_pos, sl.problem.pt_pos)
    assert torch.equal(sd.problem.cam_t, sl.problem.cam_t)


# ---------------------------------------------------------------------------
# The Schur system near lambda's floor (is it still positive definite?)
# ---------------------------------------------------------------------------

LAMBDA_FLOOR = 1e-10     # lm_step's lower clamp on lambda


def _schur_blocks(pkg, state, cam, kind=jmest.TUKEY):
    """The (C, 6, C, 6) Schur system of the free cameras at the state's
    lambda, from the package's own accumulators (dense path)."""
    bundle, mest, xp = ((jbundle, jmest, jnp) if pkg == "jax"
                        else (tbundle, tmest, torch))
    prob = state.problem
    C, P = prob.cam_R.shape[0], prob.pt_pos.shape[0]
    _, _, _, err_sq, bad_proj = bundle._project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    active = prob.meas_valid & ~prob.meas_bad
    sigma_sq = mest.find_sigma_squared(err_sq, active & ~bad_proj, kind,
                                       min_sigma=CFG.min_sigma)
    if pkg == "jax":
        U, _, V9, _, W2d, *_ = bundle._accumulators(prob, cam, sigma_sq, CFG,
                                                    kind)
    else:
        U, _, V9, _, W, *_ = bundle._accumulators(prob, state.layout, cam,
                                                  sigma_sq, CFG, kind)
        W2d = W[0, :18 * C]
    Vi = bundle._vinv_cols(V9, state.lam)
    WV = bundle._wv_product(W2d, Vi, C * 6, P)
    S_off = (WV @ W2d.reshape(C * 6, 3 * P).T).reshape(C, 6, C, 6)
    Ustar = U * (xp.ones((6, 6)) + state.lam * xp.eye(6))
    return -S_off + xp.einsum("jab,jk->jakb", Ustar, xp.eye(C))


def _schur(pkg, state, cam):
    """The camera Schur system S that ``lm_step`` factors (the fixed
    cameras' blocks the identity), as float64 numpy (6C, 6C)."""
    if pkg == "jax":
        with jax.default_matmul_precision("float32"):
            S = jax.jit(lambda s, c: _schur_blocks("jax", s, c))(state, cam)
    else:
        S = _schur_blocks("port", state, cam)
    prob = state.problem
    C = prob.cam_R.shape[0]
    free = np.asarray(prob.cam_valid & ~prob.cam_fixed, np.float64)
    S = np.asarray(S, np.float64) * (free[:, None, None, None]
                                     * free[None, None, :, None])
    S = S + np.einsum("jab,jk->jakb", np.broadcast_to(np.eye(6), (C, 6, 6)),
                      np.eye(C)) * (1.0 - free)[:, None, None, None]
    return S.reshape(C * 6, C * 6)


def _driven_to_the_floor(tprob, tcam):
    """The port's LM run from ``tprob`` until lambda reaches its floor (at
    most 15 steps), then lambda set to the floor: (port state, JAX state)
    of the same problem."""
    state = tbundle.init_lm(tprob)
    for _ in range(15):
        if float(state.lam) <= LAMBDA_FLOOR:
            break
        state = tbundle.lm_step(state, tcam)
    prob = dataclasses.replace(state.problem)
    tstate = dataclasses.replace(tbundle.init_lm(prob),
                                 lam=torch.tensor(LAMBDA_FLOOR))
    jprob = jbundle.BundleProblem(**{
        f.name: jnp.asarray(getattr(prob, f.name).numpy())
        for f in dataclasses.fields(prob)})
    jstate = jbundle.init_lm(jprob)._replace(lam=jnp.float32(LAMBDA_FLOOR))
    return tstate, jstate


def _init_after_triangulation():
    """tests/test_torch_initializer.py's init (JAX-rendered frames of the
    e2e scene, 256 trails, frames 0 and 6), stopped before its first BA:
    the map then has two keyframes, keyframe 0 fixed, and a free scale."""
    from ptam_cg_tpu.io import synth as jsynth
    from ptam_cg_tpu_torch.models import initializer as tinit
    from ptam_cg_tpu_torch.models import keyframe as tkf
    from ptam_cg_tpu_torch.models import map_state as tms
    from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
    size = (320, 240)
    seq = jsynth.SyntheticSequence(
        (1.0803, 1.43987, 0.519983, 0.548655, 0.244943), image_size=size,
        n_frames=26, seed=5, height=1.5, radius=0.35, sweep=1.3)
    ff = [tkf.build_frame(torch.from_numpy(np.array(seq.frame(i))),
                          candidate_min_score=70.0) for i in range(7)]
    trails = tinit.trail_start(ff[0], size, 256)
    for i in range(1, 7):
        trails, _ = tinit.trail_advance(trails, ff[i - 1], ff[i], size)
    cam = fj.camera_from_numpy(fj.as_numpy_tree(seq.cam), "cpu")
    maker = tmapmaker.MapMaker(
        tms.empty_map(size, max_points=1024, max_kfs=8, device="cpu"), cam,
        size)

    class Stop(Exception):
        pass

    def stop(*_, **__):
        raise Stop

    maker.bundle_adjust_all = stop
    u = torch.rand((300, 1024), generator=torch.Generator().manual_seed(0))
    with pytest.raises(Stop):
        tinit.init_from_stereo(maker, ff[0], ff[6], trails, u)
    return maker.map, cam, seq.cam


@pytest.mark.parametrize("scene", ["ba_map, keyframes 0 and 1 fixed",
                                   "init after triangulation"])
def test_schur_at_the_lambda_floor_matches_jax(scene):
    """Both packages' ``lm_step`` at lambda's floor on the same converged
    problem: the same ``failed`` flag; and the smallest eigenvalue of the
    Schur system each factors has the same sign unless its size is within
    the spectral norm of the difference of the two float32 systems (then
    the sign is float32 noise). A package's own float32 Cholesky of its
    system (plus lm_step's 1e-8 I) fails exactly where that system is
    indefinite, and then its ``lm_step`` raises lambda and tries again.
    On the init map at least one package's system is indefinite: the
    reproduction of ROADMAP.md §3's item. Both eigenvalues are printed:
    ROADMAP.md §3 records them."""
    from ptam_cg_tpu_torch.models import mapmaker as tmapmaker
    if scene.startswith("ba_map"):
        m, cam = tsynth.ba_map(n_kfs=10, max_kfs=16, n_pts=256, seed=3,
                               image_size=(64, 64), device="cpu")
        m.kf_fixed[:] = False
        m.kf_fixed[[0, 1]] = True
        jcam = jbundle.atan.make_camera(*tsynth.BA_CAMERA)
    else:
        m, cam, jcam = _init_after_triangulation()
    valid = m.kf_valid
    tprob, *_ = tmapmaker.extract_bundle(
        m, valid & ~m.kf_fixed, valid & m.kf_fixed, m.point_valid,
        int(m.meas_valid.sum()))
    tstate, jstate = _driven_to_the_floor(tprob, cam)
    S = {"jax": _schur("jax", jstate, jcam), "port": _schur("port", tstate,
                                                             cam)}
    fixed_one = np.abs(np.diag(S["port"]) - 1.0) < 1e-12
    low = {}
    for pkg, Sp in S.items():
        w = np.linalg.eigvalsh(Sp[~fixed_one][:, ~fixed_one])
        low[pkg] = (w.min(), w.max())
    noise = np.linalg.norm(S["jax"] - S["port"], 2)
    jout = jbundle._cached_lm_step(CFG, jmest.TUKEY)(jstate, jcam)
    tout = tbundle.lm_step(tstate, cam)
    print(f"{scene}: Schur smallest / largest eigenvalue at lambda "
          f"{LAMBDA_FLOOR}: JAX {low['jax'][0]:.6g} / {low['jax'][1]:.6g}, "
          f"port {low['port'][0]:.6g} / {low['port'][1]:.6g}; |S_jax - "
          f"S_port| {noise:.6g}; lambda tries JAX {int(jout.iters)}, port "
          f"{int(tout.iters)}; failed JAX {bool(jout.failed)}, port "
          f"{bool(tout.failed)}")
    assert bool(jout.failed) == bool(tout.failed)
    lj, lp = low["jax"][0], low["port"][0]
    assert np.sign(lj) == np.sign(lp) or max(abs(lj), abs(lp)) <= noise
    eye = np.eye(S["jax"].shape[0], dtype=np.float32)
    chol_fails = {
        "jax": not bool(jnp.all(jnp.isfinite(jax.scipy.linalg.cho_factor(
            jnp.asarray(S["jax"], jnp.float32) + 1e-8 * eye,
            lower=True)[0]))),
        "port": int(torch.linalg.cholesky_ex(torch.from_numpy(
            S["port"].astype(np.float32) + 1e-8 * eye))[1]) != 0}
    tries = {"jax": int(jout.iters), "port": int(tout.iters)}
    for pkg in S:
        assert chol_fails[pkg] == (low[pkg][0] < 0.0), pkg
        assert tries[pkg] >= 1 + chol_fails[pkg], pkg
    if scene.startswith("init"):
        assert min(lj, lp) < 0.0
