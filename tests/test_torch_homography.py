"""Homography init and the small eigen-solvers under it: the PyTorch port
against the JAX package and against float64 numpy.

The scenes are tests/test_homography.py's six (points on a plane at z=3
seen from two poses; outliers, noise and a pure rotation among them),
built once with the JAX package and handed to the port as numpy. The
port is fed JAX's MLESAC draws, ``jax.random.uniform(key, (trials, N))``.

Tolerances:

- ``sym_eigh``: one sweep past ``EIGH_SWEEPS`` changes no eigenvector
  entry by more than 1e-6 (9x9 DLT, 3x3 covariance and HᵀH, random 4x4
  Gram matrices). On the all-match DLT systems the smallest
  eigenvector is within 1e-4 of a float64 ``eigh`` of the same matrix, up
  to sign. On 4-point MLESAC systems the float32 normal matrix's two
  smallest eigenvalues may lie within float32 rounding of its largest,
  and then no float32 solver resolves the null vector to 1e-4: there the
  port's vector is held to the perturbation bound eps*lmax/gap (or 1e-4,
  the larger) and its Rayleigh quotient to within eps*lmax of the
  smallest eigenvalue. The test prints the gaps and how close the port
  and JAX's float32 ``eigh`` come to the bound.
- ``svd3``: U diag(s) V^T reconstructs H within 1e-5 of its norm; U and V
  orthonormal within 1e-5; the singular values within 1e-5 of the
  largest (they come from H^T H's eigenvalues).
- ``compute``: the same success; the same inlier count but for matches
  whose error lies within 1% of the 25 px^2 cap; H/|H| within 1e-4 up to
  sign; the chosen R within 1e-4, and the t and n directions within 1e-4.
  On the pure rotation H is nearly a rotation, its singular values nearly
  equal, and the decomposition is float32 noise: there each R is held to
  tests/test_homography.py's bar, 0.05 rad from the true rotation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_homography import make_planar_matches
from ptam_cg_tpu.models import homography as jhomog
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.models import homography as thomog
from ptam_cg_tpu_torch.utils import geometry as tgeometry

torch.set_num_threads(2)

TRIALS = 300
EPS = float(np.finfo(np.float32).eps)
#: test_homography.py's scenes: make_planar_matches keywords, then the
#: MLESAC key's seed.
SCENES = {
    "clean": (dict(seed=0), 0),
    "outliers": (dict(seed=1, outlier_frac=0.2), 1),
    "noisy": (dict(seed=2, noise=5e-4), 2),
    "transfer": (dict(seed=3), 3),
    "jits": (dict(seed=4), 0),
    "pure_rotation": (dict(seed=5, xi=np.array([0, 0, 0, 0.02, -0.03, 0.01],
                                               np.float32)), 5),
}


@pytest.fixture(scope="module")
def scenes():
    return {name: make_planar_matches(**kw)[0]
            for name, (kw, _) in SCENES.items()}


@pytest.fixture(scope="module")
def jax_results(scenes):
    """JAX's ``compute`` of every scene (one jitted program)."""
    fn = jax.jit(jhomog.compute)
    return {name: fn(scenes[name], jax.random.PRNGKey(seed))
            for name, (_, seed) in SCENES.items()}


def _dlt_systems(scenes):
    """(all-match AᵀA per scene, 306 4-point AᵀA) as float32 numpy: 51
    4-point sets a scene, drawn as MLESAC draws them."""
    full, four = [], []
    rng = np.random.default_rng(0)
    for m in scenes.values():
        v = np.asarray(m.valid)
        rows = np.asarray(jhomog._dlt_rows(m.first, m.second))[v]
        r = rows.reshape(-1, 9)
        full.append(r.T @ r)
        for _ in range(51):
            r4 = rows[rng.choice(len(rows), 4, replace=False)].reshape(8, 9)
            four.append(r4.T @ r4)
    return (np.stack(full).astype(np.float32),
            np.stack(four).astype(np.float32))


def _vec_errors(M, v):
    """|v - v64| (max entry, sign-aligned) against float64 eigh, and the
    float64 eigenvalues."""
    w, V = np.linalg.eigh(M.astype(np.float64))
    ref = V[..., 0]
    ref = ref * np.sign(np.sum(ref * v, axis=-1, keepdims=True))
    return np.abs(v - ref).max(axis=-1), w


def test_eigh_sweeps_reach_float32_rounding(scenes, jax_results,
                                            monkeypatch):
    full, four = _dlt_systems(scenes)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(64, 50, 3)) * [1.0, 1.0, 0.01]
    cov = np.einsum("bpi,bpj->bij", pts, pts).astype(np.float32)
    Hs = np.stack([np.asarray(r.H) for r in jax_results.values()])
    HtH = np.einsum("bji,bjk->bik", Hs, Hs).astype(np.float32)
    A4 = rng.normal(size=(256, 4, 4))
    gram4 = np.einsum("bmi,bmj->bij", A4, A4).astype(np.float32)
    for M in (np.concatenate([full, four]), cov, HtH, gram4):
        n = M.shape[-1]
        a = tgeometry.sym_eigh(torch.from_numpy(M))[1]
        monkeypatch.setitem(tgeometry.EIGH_SWEEPS, n,
                            tgeometry.EIGH_SWEEPS[n] + 1)
        b = tgeometry.sym_eigh(torch.from_numpy(M))[1]
        assert float((a - b).abs().max()) <= 1e-6, n


def test_smallest_eigvec_matches_float64(scenes):
    full, four = _dlt_systems(scenes)
    v = tgeometry.smallest_eigvec(torch.from_numpy(full)).double().numpy()
    err, _ = _vec_errors(full, v)
    assert err.max() <= 1e-4, err
    v = tgeometry.smallest_eigvec(torch.from_numpy(four)).double().numpy()
    err, w = _vec_errors(four, v)
    lmax = w[:, -1]
    bound = np.maximum(1e-4, EPS * lmax / (w[:, 1] - w[:, 0]))
    assert np.all(err <= bound), (err / bound).max()
    rq = np.einsum("bi,bij,bj->b", v, four.astype(np.float64), v)
    assert np.all(rq - w[:, 0] <= EPS * lmax)
    jv = np.asarray(jnp.linalg.eigh(jnp.asarray(four))[1][..., 0],
                    np.float64)
    jerr, _ = _vec_errors(four, jv)
    gap = (w[:, 1] - w[:, 0]) / lmax
    print(f"4-point DLT systems: gap / lmax {gap.min():.2e} to "
          f"{gap.max():.2e}; the largest error / perturbation bound: port "
          f"{np.max(err / bound):.3f}, JAX eigh {np.max(jerr / bound):.3f}; "
          f"errors over 1e-4: port {int(np.sum(err > 1e-4))}, JAX "
          f"{int(np.sum(jerr > 1e-4))} of {len(err)}")
    # The canonical sign: the largest-magnitude entry is positive.
    big = np.take_along_axis(v, np.abs(v).argmax(-1)[:, None], -1)
    assert np.all(big > 0)


def test_svd3_and_det3(jax_results):
    rng = np.random.default_rng(2)
    Hs = [np.asarray(r.H) for r in jax_results.values()]
    Hs = np.stack(Hs + list(rng.normal(size=(32, 3, 3)))).astype(np.float32)
    H = torch.from_numpy(Hs)
    U, s, V = tgeometry.svd3(H)
    rec = U @ torch.diag_embed(s) @ V.transpose(-1, -2)
    scale = torch.linalg.matrix_norm(H)[:, None, None]
    assert float(((rec - H).abs() / scale).max()) <= 1e-5
    eye = torch.eye(3)
    for Q in (U, V):
        assert float((Q.transpose(-1, -2) @ Q - eye).abs().max()) <= 1e-5
    assert bool((s[:, :-1] >= s[:, 1:]).all())
    # From the eigenvalues of H^T H: a singular value is exact to float32
    # rounding of the largest, not of itself.
    s64 = np.linalg.svd(Hs.astype(np.float64))[1]
    assert np.all(np.abs(s.numpy() - s64) <= 1e-5 * s64[:, :1])
    np.testing.assert_allclose(tgeometry.det3(H).numpy(), np.linalg.det(Hs),
                               rtol=1e-4, atol=1e-6)


def _unit(x):
    return x / np.linalg.norm(x)


def _same_direction(a, b, tol):
    a, b = _unit(np.asarray(a, np.float64)), _unit(np.asarray(b, np.float64))
    return np.abs(a - b).max() <= tol


@pytest.mark.parametrize("name", list(SCENES))
def test_compute_matches_jax(scenes, jax_results, name):
    m = scenes[name]
    key = jax.random.PRNGKey(SCENES[name][1])
    u = jax.random.uniform(key, (TRIALS, m.first.shape[0]))
    jres = fj.homography_result_from_numpy(
        fj.as_numpy_tree(jax_results[name]), "cpu")
    tm = fj.matches_from_numpy(fj.as_numpy_tree(m), "cpu")
    tres = thomog.compute(tm, torch.from_numpy(np.array(u)))
    assert bool(tres.success) == bool(jres.success)

    # Inliers are counted under the MLESAC homography: a match whose error
    # lies within 1% of the cap may fall either side.
    tH0 = thomog.mlesac_homography(tm, torch.from_numpy(np.array(u)))
    err = thomog._pixel_errors(tH0, tm).numpy()
    near = np.sum(np.asarray(m.valid) & (np.abs(err - 25.0) <= 0.25))
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= near

    Hj, Ht = jres.H.numpy(), tres.H.numpy()
    Hj, Ht = Hj / np.linalg.norm(Hj), Ht / np.linalg.norm(Ht)
    assert min(np.abs(Hj - Ht).max(), np.abs(Hj + Ht).max()) <= 1e-4

    js, ts = jres.se3_second_from_first, tres.se3_second_from_first
    if name == "pure_rotation":
        _, T21 = make_planar_matches(**SCENES[name][0])
        for R in (ts.R.numpy(), js.R.numpy()):
            c = (np.trace(R @ np.asarray(T21.R).T) - 1.0) / 2.0
            assert np.arccos(np.clip(c, -1.0, 1.0)) < 0.05
    else:
        np.testing.assert_allclose(ts.R.numpy(), js.R.numpy(), atol=1e-4)
        assert _same_direction(ts.t.numpy(), js.t.numpy(), 1e-4)
        # n: the plane normal in view 1 of the chosen candidate.
        jR, jt, jn, jd, _ = jhomog.decompose_homography(
            jax_results[name].H)
        tR, tt, tn, td, _ = thomog.decompose_homography(tres.H)
        ji = int(np.argmin(np.abs(np.asarray(jR) - js.R.numpy()).sum((1, 2))
                           + np.abs(np.asarray(jt) - js.t.numpy()).sum(1)))
        ti = int(torch.argmin((tR - ts.R).abs().sum((1, 2))
                              + (tt - ts.t).abs().sum(1)))
        nj, nt = np.asarray(jn[ji]), tn[ti].numpy()
        assert _same_direction(nt, nj * np.sign(nt @ nj), 1e-4)
