"""Witnesses for two differences between the packages' engines on
bench_engine.py's orbit at 320x240 (seed 7, 240 frames, candidate
threshold 100, 4096 point and 16 keyframe slots, deterministic mode, the
port fed ``JaxDraws``), where init waits for frame ~111 because the
trails barely move (ROADMAP §3). Not a test: each part runs both
engines for a few minutes on the CPU and prints what it finds.

    python tests/witness_bench_engine_320.py homography
        Frames rounded to uint8. At the init attempt both packages took
        their H from, it refines each package's MLESAC H with JAX's and
        the port's ``refine_homography`` in float32 and with the port's in
        float64, 5 iterations as ``compute`` does, and 50 in float64.

    python tests/witness_bench_engine_320.py ba
        Frames truncated to uint8. Runs the port's engine (2 threads)
        until its MapMaker asks for a reset, keeps the map of the BA run
        that failed, and runs that BA again from the same map: the whole
        run in both MapMakers, then each package's LM step by step on its
        own extract (the port on 1, 2 and 4 threads), and whole LM runs of
        both packages from the problem's points moved by float32 noise.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_engine import REF_PARAMS, JaxDraws  # noqa: E402

from ptam_cg_tpu.camera import atan as jatan  # noqa: E402
from ptam_cg_tpu.config import (CameraConfig, EngineConfig,  # noqa: E402
                                MapMakerConfig)
from ptam_cg_tpu.io import synth  # noqa: E402
from ptam_cg_tpu.models import bundle as jbundle  # noqa: E402
from ptam_cg_tpu.models import engine as jengine  # noqa: E402
from ptam_cg_tpu.models import homography as jhom  # noqa: E402
from ptam_cg_tpu.models import map_state as jms  # noqa: E402
from ptam_cg_tpu.models import mapmaker as jmapmaker  # noqa: E402
from ptam_cg_tpu_torch import config as tconfig  # noqa: E402
from ptam_cg_tpu_torch.models import bundle as tbundle  # noqa: E402
from ptam_cg_tpu_torch.models import engine as tengine  # noqa: E402
from ptam_cg_tpu_torch.models import homography as thom  # noqa: E402
from ptam_cg_tpu_torch.models import map_state as tms  # noqa: E402
from ptam_cg_tpu_torch.models import mapmaker as tmapmaker  # noqa: E402

SIZE = (320, 240)
N_FRAMES = 240
CAPACITY = dict(max_points=4096, max_kfs=16, auto_init_frames=6, seed=0)
N_NOISY = 16


def frames(rounding, n):
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE,
                                  n_frames=N_FRAMES, seed=7, height=1.5,
                                  radius=0.35, sweep=1.3)
    cast = np.round if rounding else (lambda x: x)
    return [np.clip(cast(np.asarray(seq.frame(i))), 0, 255).astype(np.uint8)
            for i in range(n)]


def jax_engine():
    cfg = EngineConfig(
        camera=CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=MapMakerConfig(candidate_min_shi_tomasi_score=100.0))
    return jengine.SLAMEngine(cfg, image_size=SIZE, deterministic=True,
                              **CAPACITY)


def port_engine():
    cfg = tconfig.EngineConfig(
        camera=tconfig.CameraConfig(params=REF_PARAMS, image_size=SIZE),
        mapmaker=tconfig.MapMakerConfig(candidate_min_shi_tomasi_score=100.0))
    return tengine.SLAMEngine(cfg, image_size=SIZE, deterministic=True,
                              device="cpu", draws=JaxDraws(0), **CAPACITY)


def by_h22(H):
    H = np.asarray(H, np.float64)
    return H / H[2, 2]


def homography():
    calls = {"jax": [], "port": []}
    j_compute, t_compute = jhom.compute, thom.compute

    def j_wrapped(m, key, *a, **kw):
        out = j_compute(m, key, *a, **kw)
        calls["jax"].append((m, key, out))
        return out

    def t_wrapped(m, u, *a, **kw):
        out = t_compute(m, u, *a, **kw)
        calls["port"].append((m, u, out))
        return out
    jhom.compute, thom.compute = j_wrapped, t_wrapped
    je, te = jax_engine(), port_engine()
    for k, im in enumerate(frames(True, 113)):
        a, b = je.process_frame(im), te.process_frame(im)
        if "TRACKING" in (a.stage, b.stage):
            print(f"frame {k}: JAX {a.stage} ({a.n_points} points), port "
                  f"{b.stage} ({b.n_points} points)")
            break
    (mj, key, res_j), (mt, u, res_t) = calls["jax"][-1], calls["port"][-1]
    for f in dataclasses.fields(mt):
        x, y = np.asarray(getattr(mj, f.name)), getattr(mt, f.name).numpy()
        print(f"matches.{f.name}: {int((x != y).sum())} entries differ, by "
              f"at most {np.abs(x.astype(float) - y.astype(float)).max():.3e}")
    H_j = np.asarray(jhom.mlesac_homography(mj, key))
    H_t = thom.mlesac_homography(mt, u).numpy()
    print(f"MLESAC H / H22, JAX vs port: "
          f"{np.abs(by_h22(H_j) - by_h22(H_t)).max():.3e}")
    m64 = thom.Matches(mt.first.double(), mt.second.double(),
                       mt.pixel_jac.double(), mt.valid)
    converged = {}
    for name, H0 in (("JAX's", H_j), ("the port's", H_t)):
        inlier = mt.valid & (thom._pixel_errors(torch.tensor(H0), mt)
                             < 25.0)
        hj, ht = jnp.asarray(H0), torch.tensor(H0)
        h64 = torch.from_numpy(H0.astype(np.float64))
        for _ in range(5):
            hj = jhom.refine_homography(hj, mj, jnp.asarray(inlier.numpy()))
            ht = thom.refine_homography(ht, mt, inlier)
            h64 = thom.refine_homography(h64, m64, inlier)
        h64c = torch.from_numpy(H0.astype(np.float64))
        for _ in range(50):
            h64c = thom.refine_homography(h64c, m64, inlier)
        converged[name] = by_h22(h64c.numpy())
        ref = by_h22(h64.numpy())
        print(f"from {name} MLESAC H ({int(inlier.sum())} inliers), 5 "
              f"refinements: JAX vs float64 "
              f"{np.abs(by_h22(hj) - ref).max():.3e}, port vs float64 "
              f"{np.abs(by_h22(ht.numpy()) - ref).max():.3e}; float64 after "
              f"5 vs 50 {np.abs(ref - converged[name]).max():.3e}")
    a, b = converged.values()
    print(f"float64 after 50 refinements, from JAX's vs the port's start: "
          f"{np.abs(a - b).max():.3e}")
    print(f"the engines' H / H22 (5 refinements), JAX vs port: "
          f"{np.abs(by_h22(res_j.H) - by_h22(res_t.H.numpy())).max():.3e}")


def lm_rows(step, state, max_iterations):
    rows = []
    while True:
        state, (conv, iters, failed, accepted) = step(state)
        rows.append((iters, accepted, failed, round(float(state[1]), 4)))
        if conv or failed or iters >= max_iterations:
            return rows
        state = state[0]


def ba():
    torch.set_num_threads(2)
    eng = port_engine()
    snap = {}

    def watch(mm):
        start = mm._ba_start

        def wrapped(adjust, fixed, pmask, recent, full=False):
            snap.update(map=tms.copy_map(mm.map), adjust=adjust.clone(),
                        fixed=fixed.clone(), pmask=pmask.clone(),
                        recent=recent, full=full, caps=mm._ba_caps(),
                        hints={k: getattr(mm, k) for k in (
                            "_n_points_hint", "_n_kfs_host", "_tier_c_floor",
                            "_tier_p_floor", "_tier_m_floor", "_last_n_sel")})
            return start(adjust, fixed, pmask, recent, full)
        mm._ba_start = wrapped
    watch(eng.mapmaker)
    for k, im in enumerate(frames(False, N_FRAMES)):
        mm = eng.mapmaker
        eng.process_frame(im)
        if mm.reset_requested:
            break
        if eng.mapmaker is not mm:
            watch(eng.mapmaker)
    else:
        print("no BA run failed on these frames")
        return
    m0 = snap["map"]
    print(f"frame {k}: a {'local' if snap['recent'] else 'global'} BA "
          f"failed; map: {int(m0.kf_valid.sum())} keyframes (fixed "
          f"{m0.kf_fixed.nonzero()[:, 0].tolist()}), "
          f"{int(m0.point_valid.sum())} points; caps {snap['caps']}")
    args = (snap["adjust"], snap["fixed"], snap["pmask"])
    jm0 = jms.MapState(**{f.name: jnp.asarray(getattr(m0, f.name).numpy())
                          for f in dataclasses.fields(m0)})
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    jcam = jatan.make_camera(REF_PARAMS, SIZE)
    makers = (("port", tmapmaker.MapMaker(tms.copy_map(m0), eng.mapmaker.cam,
                                          SIZE, deterministic=True), args),
              ("JAX", jmapmaker.MapMaker(jm0, jcam, SIZE), jargs))
    for name, maker, a in makers:
        for attr, v in snap["hints"].items():
            setattr(maker, attr, v)
        assert maker._ba_caps() == snap["caps"]
        maker.bundle_adjust(*a, snap["recent"], snap["full"])
        print(f"{name} MapMaker, the same BA again: reset requested "
              f"{maker.reset_requested}, converged (recent, full) "
              f"{maker.converged_recent, maker.converged_full}")
    cfg, mm = eng.mapmaker.ba_cfg, eng.mapmaker
    prob = tmapmaker.extract_bundle_compact(m0, *args, *snap["caps"])[0]

    def t_step(s):
        s, f = tbundle.lm_step_flags(s, mm.cam, cfg, mm._kind)
        return (s, s.last_error), f
    for threads in (1, 2, 4):
        torch.set_num_threads(threads)
        rows = lm_rows(t_step, tbundle.init_lm(prob, cfg),
                       cfg.max_iterations)
        print(f"port LM on {threads} thread(s), (iterations, accepted, "
              f"failed, error): {rows}")
    jcfg = makers[1][1].ba_cfg
    jstep = jbundle._cached_lm_step(
        jcfg, jbundle.mest.estimator_id(jcfg.mestimator))

    def j_step(s):
        s = jstep(s, jcam)
        return (s, s.last_error), (bool(s.converged), int(s.iters),
                                   bool(s.failed), int(s.accepted))
    jprob = jmapmaker.extract_bundle_compact(jm0, *jargs, *snap["caps"])[0]
    rows = lm_rows(j_step, jbundle.init_lm(jprob, jcfg), jcfg.max_iterations)
    print(f"JAX LM, (iterations, accepted, failed, error): {rows}")

    # The same problem with its points moved by float32 noise (a relative
    # 1e-7, seeded): how many whole LM runs end failed in each package.
    torch.set_num_threads(2)
    ends = {"port": [], "JAX": []}
    for seed in range(N_NOISY):
        noise = 1.0 + 1e-7 * np.random.default_rng(seed).standard_normal(
            tuple(prob.pt_pos.shape)).astype(np.float32)
        t_prob = dataclasses.replace(
            prob, pt_pos=prob.pt_pos * torch.from_numpy(noise))
        j_prob = jprob._replace(pt_pos=jprob.pt_pos * jnp.asarray(noise))
        ends["port"].append(lm_rows(t_step, tbundle.init_lm(t_prob, cfg),
                                    cfg.max_iterations)[-1][:3])
        ends["JAX"].append(lm_rows(j_step, jbundle.init_lm(j_prob, jcfg),
                                   jcfg.max_iterations)[-1][:3])
    for name, rows in ends.items():
        print(f"{name}, {N_NOISY} runs from noisy points: "
              f"{sum(bool(r[2]) for r in rows)} failed; (iterations, "
              f"accepted, failed) at the end: {rows}")


if __name__ == "__main__":
    {"homography": homography, "ba": ba}[sys.argv[1]]()
