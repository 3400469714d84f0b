"""K4 (the tracker's Gauss-Newton pose loop) and K5 (the SBI ESM
alignment): plain versions against the JAX package, the wrappers'
refusals, and the kernels against their plain versions on the card.

Inputs are made from numpy seeds and fed to both packages.

- K4: ``kernels/pose_gn.py`` against JAX
  ``ptam_cg_tpu.models.tracker._gn_pose_iterations`` for each of the four
  estimators, at N = 128 (the coarse call: exact median), N = 1152 (the
  final call: the approximate median's 64 rows of 18) and N = 600 (rows
  of 19 with 8 padded slots), and a noise-free case that settles early.
  Bars: pose (rotation entries and translation) within 1e-5, the tracker
  tests' ``POSE_TOL``: the sums over the points run in another order, and
  the poses part by about 1e-7. Weights within 2e-5 at the final call's
  sigma^2 of 16 and within 2e-5 * 16 / sigma^2 below it (``w_tol``): the
  last weights are computed at sigma^2 = override_val from the pose before
  the last step, and a weight is a function of err^2 / sigma^2, so the
  same 1e-7 of pose noise moves a weight 16 times as far at the coarse
  call's sigma^2 of 1. Measured: 8.5e-6 (sigma^2 = 16) and 3.9e-5
  (sigma^2 = 1) between the port and JAX here, 1.2e-5 (sigma^2 = 16)
  between the kernel and the plain version on an H100.
- K5: ``kernels/sbi_esm.py`` against JAX ``iterate_pos_rel_to_target`` at
  the SBI sizes of 320x240 (15x20) and 640x480 (30x40) frames: SE2 within
  1e-5, score within 1e-4 relative (a sum of ~1000 squares).
- On the card (``cuda`` marker; skipped without a GPU): each kernel
  against its plain version at the same bars (K5 also at the SBIs of
  1280x720 and 1920x1080 frames), two launches bit-identical, and K4's
  early exit. A GPU machine need not have JAX: run them with
  ``python -m pytest tests/test_torch_pose_kernels.py -m cuda
  --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch.camera import atan as tatan
from ptam_cg_tpu_torch.kernels import pose_gn as kpose
from ptam_cg_tpu_torch.kernels import sbi_esm as kesm
from ptam_cg_tpu_torch.ops import sbi as tsbiops
from ptam_cg_tpu_torch.utils import mest as tmest
from ptam_cg_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (640, 480)
POSE_TOL = 1e-5
W_TOL = 2e-5
SE2_TOL = 1e-5
SCORE_RTOL = 1e-4
KINDS = ("tukey", "cauchy", "huber", "lsq")
#: (N, override_val): the coarse and the final call of track_map, and a
#: size whose approximate median pads its rows.
SIZES = ((128, 1.0), (1152, 16.0), (600, 16.0))


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ptam_cg_tpu.camera import atan
    from ptam_cg_tpu.models import tracker
    from ptam_cg_tpu.ops import sbi
    from ptam_cg_tpu.utils import se3
    gn = jax.jit(tracker._gn_pose_iterations,
                 static_argnums=(2, 7, 8, 9, 10))
    esm = jax.jit(sbi.iterate_pos_rel_to_target, static_argnums=2)
    return types.SimpleNamespace(jax=jax, jnp=jnp, atan=atan, se3=se3,
                                 gn=gn, esm=esm, make_sbi=jax.jit(
                                     sbi.make_sbi, static_argnums=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rodrigues(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def gn_inputs(N, seed, noise=True):
    """A true pose, N world points in front of it (a few behind or off the
    image), their projections through the port's camera as found
    positions (with 0.3 px noise a level px and 10% outliers when
    ``noise``), 85% found, levels 0-3, and a start pose 0.02 rad and
    0.03 off. Numpy arrays (float32 / bool / int64)."""
    rng = np.random.default_rng(seed)
    R_gt = _rodrigues(rng.normal(0, 0.2, 3))
    t_gt = rng.normal(0, 0.3, 3)
    z = rng.uniform(1.0, 4.0, N)
    p_cam = np.stack([rng.uniform(-0.7, 0.7, N) * z,
                      rng.uniform(-0.55, 0.55, N) * z, z], -1)
    p_cam[:3, 2] = -1.0                          # behind the camera
    pts = (p_cam - t_gt) @ R_gt                  # R^T (p - t)
    cam = tatan.make_camera(REF_PARAMS, SIZE, "cpu")
    pc = torch.from_numpy(p_cam.astype(np.float32))
    pix = tatan.project(pc[:, :2] / pc[:, 2:], cam).double().numpy()
    level = rng.integers(0, 4, N)
    if noise:
        pix += rng.normal(0, 0.3, (N, 2)) * (2.0 ** level)[:, None]
        out = rng.random(N) < 0.1
        pix[out] += rng.uniform(-25, 25, (int(out.sum()), 2))
    found = rng.random(N) < 0.85
    R0 = _rodrigues(rng.normal(0, 0.02 / np.sqrt(3), 3)) @ R_gt
    t0 = t_gt + rng.normal(0, 0.03 / np.sqrt(3), 3)
    f32 = np.float32
    return dict(R=R0.astype(f32), t=t0.astype(f32), pts=pts.astype(f32),
                found=found, v2=pix.astype(f32), level=level.astype(np.int64))


def torch_args(d, device="cpu"):
    cam = tatan.make_camera(REF_PARAMS, SIZE, device)
    dev = torch.device(device)
    return (tse3.SE3(torch.from_numpy(d["R"]).to(dev),
                     torch.from_numpy(d["t"]).to(dev)), cam, SIZE,
            torch.from_numpy(d["pts"]).to(dev),
            torch.from_numpy(d["found"]).to(dev),
            torch.from_numpy(d["v2"]).to(dev),
            torch.from_numpy(d["level"]).to(dev))


def jax_gn(jr, d, cam, n_iters, override_after, override_val, kind):
    jnp = jr.jnp
    R, w = jr.gn(jr.se3.SE3(jnp.asarray(d["R"]), jnp.asarray(d["t"])), cam,
                 SIZE, jnp.asarray(d["pts"]), jnp.asarray(d["found"]),
                 jnp.asarray(d["v2"]), jnp.asarray(d["level"], jnp.int32),
                 n_iters, override_after, override_val, kind)
    return np.asarray(R.R), np.asarray(R.t), np.asarray(w)


def jax_camera(jr):
    return jr.atan.make_camera(jr.jnp.asarray(REF_PARAMS, jr.jnp.float32),
                               SIZE)


def w_tol(override_val):
    return W_TOL * 16.0 / override_val


def assert_pose_close(R, t, R_ref, t_ref, tol=POSE_TOL):
    np.testing.assert_allclose(np.asarray(R), R_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(np.asarray(t), t_ref, rtol=0, atol=tol)


@pytest.mark.parametrize("N,override_val", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_pose_gn_plain_matches_jax(jax_ref, kind, N, override_val):
    d = gn_inputs(N, seed=N + len(kind))
    k = tmest.estimator_id(kind)
    R_ref, t_ref, w_ref = jax_gn(jax_ref, d, jax_camera(jax_ref), 10, 5,
                                 override_val, k)
    pose, w = kpose.pose_gn(*torch_args(d), 10, 5, override_val, k)
    assert_pose_close(pose.R, pose.t, R_ref, t_ref)
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=0,
                               atol=w_tol(override_val))
    # The solve moved the pose, and the robust weights are not all equal.
    assert np.abs(R_ref - d["R"]).max() > 1e-3
    if kind != "lsq":
        assert (w_ref[d["found"]] < 0.99).any()


def test_pose_gn_plain_settles_like_jax(jax_ref):
    """Noise-free found positions: the loop settles right after
    override_after, so 7 iterations give the 10-iteration result exactly,
    and JAX's while_loop exits there too."""
    d = gn_inputs(1152, seed=3, noise=False)
    R_ref, t_ref, w_ref = jax_gn(jax_ref, d, jax_camera(jax_ref), 10, 5,
                                 16.0, tmest.TUKEY)
    pose, w = kpose.pose_gn(*torch_args(d), 10, 5, 16.0, tmest.TUKEY)
    pose7, w7 = kpose.pose_gn(*torch_args(d), 7, 5, 16.0, tmest.TUKEY)
    assert torch.equal(pose.R, pose7.R) and torch.equal(pose.t, pose7.t)
    assert torch.equal(w, w7)
    assert_pose_close(pose.R, pose.t, R_ref, t_ref)
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=0, atol=W_TOL)


def sbi_pair(jr, hw, seed):
    """Two SBIs (JAX's make_sbi, blur 0.75 as the rotation estimator's) of
    a texture crop and the same crop moved by a few level-3 px, as numpy
    dicts."""
    from ptam_cg_tpu_torch.io import synth as tsynth
    h, w = hw
    tex = tsynth.make_texture(np.random.default_rng(seed), device="cpu")
    tex = tex.numpy()
    r = np.random.default_rng(seed + 1)
    y, x = r.integers(8, tex.shape[0] - 2 * h - 8), r.integers(
        8, tex.shape[1] - 2 * w - 8)
    dy, dx = r.integers(-3, 4, 2)
    lev3 = tex[y: y + 2 * h, x: x + 2 * w]
    moved = tex[y + dy: y + dy + 2 * h, x + dx: x + dx + 2 * w]
    out = []
    for im in (moved, lev3):
        s = jr.make_sbi(jr.jnp.asarray(im), 0.75)
        out.append(dict(template=np.array(s.template),
                        jac=np.array(s.jac)))
    return out


@pytest.mark.parametrize("hw", [(15, 20), (30, 40)])
@pytest.mark.parametrize("seed", [1, 2])
def test_sbi_esm_plain_matches_jax(jax_ref, hw, seed):
    jnp = jax_ref.jnp
    from ptam_cg_tpu.ops import sbi as jsbi
    moving, target = sbi_pair(jax_ref, hw, seed)
    se2_ref, score_ref = jax_ref.esm(
        jsbi.SBI(*(jnp.asarray(moving[f]) for f in ("template", "jac"))),
        jsbi.SBI(*(jnp.asarray(target[f]) for f in ("template", "jac"))),
        10)
    se2, score = tsbiops.iterate_pos_rel_to_target(
        tsbiops.SBI(*(torch.from_numpy(moving[f])
                      for f in ("template", "jac"))),
        tsbiops.SBI(*(torch.from_numpy(target[f])
                      for f in ("template", "jac"))), 10)
    assert_pose_close(se2.R, se2.t, np.asarray(se2_ref.R),
                      np.asarray(se2_ref.t), SE2_TOL)
    np.testing.assert_allclose(float(score), float(score_ref),
                               rtol=SCORE_RTOL)
    assert np.abs(np.asarray(se2_ref.t)).max() > 0.1     # it moved


def test_pose_gn_refuses_what_the_kernel_cannot_take():
    args = list(torch_args(gn_inputs(128, seed=0)))
    kpose.validate(args[0], args[1], *args[3:], 10, tmest.TUKEY)
    pose, cam, _, pts, found, v2, level = args
    bad = {
        "dtype": (pose, cam, pts.double(), found, v2, level),
        "level dtype": (pose, cam, pts, found, v2, level.to(torch.int32)),
        "found dtype": (pose, cam, pts, found.to(torch.uint8), v2, level),
        "strided": (pose, cam, torch.zeros(3, 128).T, found, v2, level),
        "strided pose": (tse3.SE3(pose.R.T, pose.t), cam, pts, found, v2,
                         level),
        "capacity": (pose, cam, torch.zeros(kpose.MAX_N + 1, 3),
                     torch.zeros(kpose.MAX_N + 1, dtype=torch.bool),
                     torch.zeros(kpose.MAX_N + 1, 2),
                     torch.zeros(kpose.MAX_N + 1, dtype=torch.int64)),
        "empty": (pose, cam, torch.zeros(0, 3), found[:0], v2[:0],
                  level[:0]),
        "shape": (pose, cam, pts, found[:100], v2, level),
    }
    for what, a in bad.items():
        with pytest.raises(ValueError):
            kpose.validate(*a, 10, tmest.TUKEY)
    with pytest.raises(ValueError):
        kpose.validate(*args[:2], *args[3:], 10, 7)
    # Not on the CPU and not on the card: no plain fallback.
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in args[3:]]
    meta_cam = tatan.Camera(**{f: getattr(cam, f).to("meta")
                               for f in tatan.Camera.__dataclass_fields__})
    with pytest.raises(ValueError, match="CUDA"):
        kpose.pose_gn(tse3.SE3(pose.R.to("meta"), pose.t.to("meta")),
                      meta_cam, SIZE, *meta, 10, 5, 1.0)


def test_sbi_esm_refuses_what_the_kernel_cannot_take():
    m, t = torch.zeros(30, 40), torch.zeros(30, 40)
    jac = torch.zeros(30, 40, 2)
    kesm.validate(m, t, jac, 10)
    # The SBI of a 1920x1080 frame fits one block.
    kesm.validate(torch.zeros(67, 120), torch.zeros(67, 120),
                  torch.zeros(67, 120, 2), 10)
    big = (kesm.MAX_PIX // 128 + 1, 128)
    bad = {
        "dtype": (m.double(), t, jac),
        "target dtype": (m, t.half(), jac),
        "strided": (m, t, torch.zeros(2, 30, 40).permute(1, 2, 0)),
        "capacity": (torch.zeros(big), torch.zeros(big),
                     torch.zeros(*big, 2)),
        "shape": (m, torch.zeros(30, 41), jac),
        "rank": (m[0], t[0], jac[0]),
    }
    for what, a in bad.items():
        with pytest.raises(ValueError):
            kesm.validate(*a, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kesm.esm(m.to("meta"), t.to("meta"), jac.to("meta"), 10)


# ----------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("N,override_val", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_pose_gn_kernel_matches_plain(cuda, kind, N, override_val):
    d = gn_inputs(N, seed=N + len(kind))
    k = tmest.estimator_id(kind)
    args = torch_args(d, "cuda")
    ref_pose, ref_w = kpose.pose_gn_plain(*args, 10, 5, override_val, k)
    before = kpose.launches
    runs = [kpose.pose_gn(*args, 10, 5, override_val, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert kpose.launches == before + 2
    (p1, w1), (p2, w2) = runs
    assert torch.equal(p1.R, p2.R) and torch.equal(p1.t, p2.t)
    assert torch.equal(w1, w2)
    assert_pose_close(p1.R.cpu(), p1.t.cpu(), ref_pose.R.cpu().numpy(),
                      ref_pose.t.cpu().numpy())
    np.testing.assert_allclose(w1.cpu().numpy(), ref_w.cpu().numpy(),
                               rtol=0, atol=w_tol(override_val))


@pytest.mark.cuda
def test_pose_gn_kernel_exits_where_the_loop_settles(cuda):
    """As ``test_pose_gn_plain_settles_like_jax``: the kernel's 7- and
    10-iteration results are equal bit for bit."""
    d = gn_inputs(1152, seed=3, noise=False)
    args = torch_args(d, "cuda")
    pose, w = kpose.pose_gn(*args, 10, 5, 16.0, tmest.TUKEY)
    pose7, w7 = kpose.pose_gn(*args, 7, 5, 16.0, tmest.TUKEY)
    ref_pose, ref_w = kpose.pose_gn_plain(*args, 10, 5, 16.0, tmest.TUKEY)
    assert torch.equal(pose.R, pose7.R) and torch.equal(pose.t, pose7.t)
    assert torch.equal(w, w7)
    assert_pose_close(pose.R.cpu(), pose.t.cpu(), ref_pose.R.cpu().numpy(),
                      ref_pose.t.cpu().numpy())
    np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(),
                               rtol=0, atol=W_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(15, 20), (30, 40), (45, 80), (67, 120)])
def test_sbi_esm_kernel_matches_plain(cuda, hw):
    """At the SBIs of 320x240, 640x480, 1280x720 and 1920x1080 frames; the
    last two take more than the default 48 kB of shared memory."""
    from ptam_cg_tpu_torch.io import synth as tsynth
    h, w = hw
    tex = tsynth.make_texture(np.random.default_rng(1), device="cpu")
    sbis = [tsbiops.make_sbi(tex[y: y + 2 * h, x: x + 2 * w].to(cuda), 0.75)
            for y, x in ((40, 60), (42, 57))]
    moving, target = sbis
    ref = kesm.esm_plain(moving.template, target.template, target.jac, 10)
    before = kesm.launches
    runs = [kesm.esm(moving.template, target.template, target.jac, 10)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert kesm.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    R, t, score = runs[0]
    assert_pose_close(R.cpu(), t.cpu(), ref[0].cpu().numpy(),
                      ref[1].cpu().numpy(), SE2_TOL)
    np.testing.assert_allclose(float(score), float(ref[2]), rtol=SCORE_RTOL)
