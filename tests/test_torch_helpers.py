"""The helpers the JAX package keeps for its tests and tools, which no path
of the engine calls: ``ops/fast.detect`` (FAST-10 on one image through
kernel K1's one-level table), ``ops/image.zero_mean``,
``ops/levels.build_atlas`` and ``utils/se3`` ``euler_from_rot``,
``rot_from_euler`` and ``lh_from_rh``; ``ops/patch.make_warped_templates_flat``
(the flat-index form of the template warp), ``ops/sbi.se2_identity`` and
``se2_mul``, ``utils/se3.generator_field``; the port against the JAX
package on the same seeded numpy inputs.

Bars: ``detect``, ``build_atlas`` and ``lh_from_rh`` exactly (FAST uses
only add, subtract, min and max; the pyramid's sums run in one order
eagerly in both; the flip is a sign); ``zero_mean`` within 1e-4 (a float32
mean over 4,800 pixels summed in another order); the Euler conversions
within 2e-6 (float32 trigonometry of two libraries);
``make_warped_templates_flat`` within 1e-5 of JAX relative to the value
(the same float32 operations in the same order; a dot of two products may
round apart), with ``good`` equal, on float32 and bfloat16 atlases; the
SE2 product within 1e-6; ``generator_field`` exactly (a copy and a sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.ops import fast as jfast
from ptam_cg_tpu.ops import image as jimage
from ptam_cg_tpu.ops import levels as jlevels
from ptam_cg_tpu.ops import patch as jpatch
from ptam_cg_tpu.ops import sbi as jsbi
from ptam_cg_tpu.utils import se3 as jse3
from ptam_cg_tpu_torch.ops import fast as tfast
from ptam_cg_tpu_torch.ops import image as timage
from ptam_cg_tpu_torch.ops import levels as tlevels
from ptam_cg_tpu_torch.ops import patch as tpatch
from ptam_cg_tpu_torch.ops import sbi as tsbi
from ptam_cg_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

EULER_TOL = 2e-6


def _image(seed, shape=(60, 80)):
    """Integer-valued blobs and noise: FAST finds corners of both
    polarities and ties of score."""
    rng = np.random.default_rng(seed)
    im = rng.integers(0, 40, shape).astype(np.float32)
    for _ in range(25):
        y, x = rng.integers(4, shape[0] - 4), rng.integers(4, shape[1] - 4)
        im[y - 2:y + 2, x - 2:x + 2] = rng.choice([0.0, 250.0])
    return im


@pytest.mark.parametrize("nonmax", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_detect_matches_jax(seed, nonmax):
    im = _image(seed)
    ref = jfast.detect(jnp.asarray(im), 20.0, 64, nonmax=nonmax)
    got = tfast.detect(torch.from_numpy(im), 20.0, 64, nonmax=nonmax)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for f in ("xy", "score", "valid", "count"):
        np.testing.assert_array_equal(getattr(got[2], f).numpy(),
                                      np.asarray(getattr(ref[2], f)), f)
    assert 0 < int(got[2].count) <= 64


def test_zero_mean_and_build_atlas_match_jax():
    im = _image(2, (48, 64))
    stack = np.stack([im, im * 0.5 + 3.0])
    np.testing.assert_allclose(timage.zero_mean(torch.from_numpy(stack)),
                               np.asarray(jimage.zero_mean(
                                   jnp.asarray(stack))), atol=1e-4)
    got = tlevels.build_atlas(torch.from_numpy(im))
    ref = jlevels.build_atlas(jnp.asarray(im))
    assert got.shape == (72, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_euler_and_handedness_match_jax():
    rng = np.random.default_rng(4)
    rpy = rng.uniform(-3.0, 3.0, (16, 3)).astype(np.float32)
    rpy[:, 1] = np.clip(rpy[:, 1], -1.5, 1.5)
    R_t = tse3.rot_from_euler(torch.from_numpy(rpy))
    R_j = np.array(jse3.rot_from_euler(jnp.asarray(rpy)))
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=EULER_TOL)
    np.testing.assert_allclose(tse3.euler_from_rot(R_t).numpy(), rpy,
                               atol=1e-4)
    np.testing.assert_allclose(
        tse3.euler_from_rot(torch.from_numpy(R_j)).numpy(),
        np.asarray(jse3.euler_from_rot(jnp.asarray(R_j))), atol=EULER_TOL)
    # Pitch at +-pi/2: yaw is 0 and roll takes the rest, in both.
    sing = np.array([[0.3, np.pi / 2, 0.0], [-0.7, -np.pi / 2, 0.0]],
                    np.float32)
    Rs = np.array(jse3.rot_from_euler(jnp.asarray(sing)))
    np.testing.assert_allclose(
        tse3.euler_from_rot(torch.from_numpy(Rs)).numpy(),
        np.asarray(jse3.euler_from_rot(jnp.asarray(Rs))), atol=EULER_TOL)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    got = tse3.lh_from_rh(tse3.SE3(R_t, torch.from_numpy(t)))
    ref = jse3.lh_from_rh(jse3.SE3(jnp.asarray(R_t.numpy()), jnp.asarray(t)))
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(ref.R))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
    back = tse3.lh_from_rh(got)
    assert torch.equal(back.R, R_t) and torch.equal(back.t,
                                                    torch.from_numpy(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warped_templates_flat_match_jax(dtype):
    """Random warps around identity at levels 0-3 of 3 keyframes' atlases;
    some samples leave their level (``good`` False) or the atlas (the
    clamped taps)."""
    rng = np.random.default_rng(11)
    K, Ha, Wa, N = 3, 72, 64, 96
    atlas = rng.integers(0, 256, (K, Ha, Wa)).astype(np.float32)
    kf_idx = rng.integers(0, K, N).astype(np.int32)
    level = rng.integers(0, 4, N)
    scale = (2.0 ** level).astype(np.float32)
    m2 = (np.eye(2, dtype=np.float32)[None] * scale[:, None, None]
          + rng.normal(0.0, 0.2, (N, 2, 2)).astype(np.float32))
    centre = rng.uniform(-2.0, [Wa + 1.0, Ha + 1.0], (N, 2)).astype(
        np.float32)
    x0 = rng.uniform(0.0, 10.0, N)
    y0 = rng.uniform(0.0, 10.0, N)
    bounds = np.stack([x0, y0, x0 + rng.uniform(30, 54, N),
                       y0 + rng.uniform(30, 60, N)], -1).astype(np.float32)
    j_atlas = jnp.asarray(atlas).astype(getattr(jnp, dtype))
    t_atlas = torch.from_numpy(atlas).to(getattr(torch, dtype))
    ref = jpatch.make_warped_templates_flat(
        j_atlas, jnp.asarray(kf_idx), jnp.asarray(centre), jnp.asarray(m2),
        jnp.asarray(bounds))
    got = tpatch.make_warped_templates_flat(
        t_atlas, torch.from_numpy(kf_idx), torch.from_numpy(centre),
        torch.from_numpy(m2), torch.from_numpy(bounds))
    assert got[0].dtype == torch.float32 and got[0].shape == (N, 8, 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert 0 < int(got[1].sum()) < N


def test_se2_matches_jax():
    rng = np.random.default_rng(5)
    th = rng.uniform(-np.pi, np.pi, 2)
    R = [np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                  np.float32) for a in th]
    t = [rng.normal(size=2).astype(np.float32) for _ in th]
    ref = jsbi.se2_mul(jsbi.SE2(jnp.asarray(R[0]), jnp.asarray(t[0])),
                       jsbi.SE2(jnp.asarray(R[1]), jnp.asarray(t[1])))
    got = tsbi.se2_mul(tsbi.SE2(torch.from_numpy(R[0]),
                                torch.from_numpy(t[0])),
                       tsbi.SE2(torch.from_numpy(R[1]),
                                torch.from_numpy(t[1])))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-6)
    eye_j, eye_t = jsbi.se2_identity(), tsbi.se2_identity("cpu")
    np.testing.assert_allclose(eye_t.R.numpy(), np.asarray(eye_j.R),
                               atol=1e-6)
    np.testing.assert_allclose(eye_t.t.numpy(), np.asarray(eye_j.t),
                               atol=1e-6)
    assert eye_t.R.dtype == eye_t.t.dtype == torch.float32
    left = tsbi.se2_mul(eye_t, got)
    assert torch.equal(left.R, got.R) and torch.equal(left.t, got.t)


@pytest.mark.parametrize("i", range(6))
def test_generator_field_matches_jax(i):
    p = np.random.default_rng(i).normal(size=(4, 5, 4)).astype(np.float32)
    got = tse3.generator_field(i, torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jse3.generator_field(
                                      i, jnp.asarray(p))))
    assert not got[..., 3].any()
