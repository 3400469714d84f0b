"""K1 (FAST-10), K2 (window gather) and K3 (Shi-Tomasi): plain versions
against the JAX package, and kernels against plain versions on the card
(K3's plain version is held to the JAX package in test_torch_keyframe.py).

Bars: bit-identical everywhere. FAST uses only f32 add, subtract, min and
max; the gather is a copy; K3 rounds every operation on its own in the
plain version's order. The card tests carry the ``cuda`` marker and
skip without a GPU. The card's machine has no JAX, so the JAX references
load through the ``jax_ref`` fixture and the card tests run there with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch.kernels import fast as kfast
from ptam_cg_tpu_torch.kernels import gather as kgather
from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi

torch.set_num_threads(2)

#: The window sides on the tracking path: search windows 40 (coarse) and
#: 30 (fine), corner-mask windows 33 and 23, template windows 28; on the
#: keyframe path: epipolar patches 8, re-find corner-mask windows 9,
#: sub-pixel windows 15 and re-find search windows 16.
PATH_WINDOWS = (8, 9, 15, 16, 23, 28, 30, 33, 40)


@pytest.fixture(scope="module")
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from ptam_cg_tpu.ops import fast, pallas_gather, pallas_kernels
    return types.SimpleNamespace(jnp=jnp, fast=fast, pg=pallas_gather,
                                 pk=pallas_kernels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,threshold,seed",
                         [((48, 64), 15.0, 5), ((120, 160), 12.0, 6)])
def test_fast_plain_matches_jax(jax_ref, shape, threshold, seed):
    """The shapes of tests/test_fast.py's Pallas parity tests."""
    jnp, fastops, pk = jax_ref.jnp, jax_ref.fast, jax_ref.pk
    im = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    mask, score = kfast.fast_score_map(torch.from_numpy(im), threshold)
    assert mask.dtype == torch.bool and mask.any()
    refs = [fastops.fast_score_map(jnp.asarray(im), threshold),
            pk.fast_score_map_banded(jnp.asarray(im), threshold,
                                     interpret=True),
            pk.fast_score_map_pallas(jnp.asarray(im), threshold,
                                     interpret=True)]
    for m_ref, s_ref in refs:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(m_ref))
        np.testing.assert_array_equal(score.numpy(), np.asarray(s_ref))


def _atlas_and_origins(D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0, 255, (120, 256)).astype(dtype)
    inside = np.stack([rng.integers(0, 120 - D + 1, 24),
                       rng.integers(0, 256 - D + 1, 24)], -1)
    # Clamped edge cases: negative, past the far edge, and both.
    edges = np.array([[-5, -7], [200, 300], [120 - D, -1], [-3, 256 - D],
                      [119, 255], [0, 0]])
    return atlas, inside.astype(np.int32), edges.astype(np.int32)


@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_plain_matches_jax(jax_ref, D):
    jnp, pg = jax_ref.jnp, jax_ref.pg
    atlas, inside, edges = _atlas_and_origins(D, D)
    got = kgather.gather_windows(torch.from_numpy(atlas),
                                 torch.from_numpy(inside), D)
    ref = pg.gather_windows_pallas(jnp.asarray(atlas), jnp.asarray(inside), D,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    both = np.concatenate([inside, edges])
    got = kgather.gather_windows(torch.from_numpy(atlas),
                                 torch.from_numpy(both), D)
    ref = pg.gather_windows_rowtake(jnp.asarray(atlas), jnp.asarray(both), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gather_plain_copies_masks(jax_ref):
    """Corner masks are gathered as bool, the same windows as the f32
    gather of the mask that the JAX package thresholds at 0.5."""
    jnp, pg = jax_ref.jnp, jax_ref.pg
    D = 23
    atlas, inside, edges = _atlas_and_origins(D, 1)
    mask = atlas > 128.0
    origins = np.concatenate([inside, edges])
    got = kgather.gather_windows(torch.from_numpy(mask),
                                 torch.from_numpy(origins), D)
    ref = pg.gather_windows_rowtake(jnp.asarray(mask.astype(np.float32)),
                                    jnp.asarray(origins), D) > 0.5
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.cuda
def test_fast_kernel_matches_plain_on_card(cuda):
    """All four pyramid levels of a 640x480 image, at the frontend's
    thresholds."""
    from ptam_cg_tpu.config import FrontendConfig
    from ptam_cg_tpu_torch.ops import image as imops
    im = np.random.default_rng(0).uniform(0, 255, (480, 640))
    pyr = imops.build_pyramid(torch.tensor(im, dtype=torch.float32,
                                           device=cuda), 4)
    for lev, t in zip(pyr, FrontendConfig().fast_thresholds):
        before = kfast.launches
        m_k, s_k = kfast.fast_score_map(lev, float(t))
        assert kfast.launches == before + 1
        m_p, s_p = kfast.fast_score_map_plain(lev, float(t))
        torch.testing.assert_close(m_k, m_p, rtol=0, atol=0)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_kernel_matches_plain_on_card(cuda, D):
    atlas, inside, edges = _atlas_and_origins(D, D)
    origins = torch.from_numpy(np.concatenate([inside, edges])).to(cuda)
    for a in (torch.from_numpy(atlas), torch.from_numpy(atlas > 128.0),
              torch.from_numpy(atlas.astype(np.uint8))):
        a = a.to(cuda)
        before = kgather.launches
        got = kgather.gather_windows(a, origins, D)
        assert kgather.launches == before + 1
        torch.testing.assert_close(got, kgather.gather_windows_plain(
            a, origins, D), rtol=0, atol=0)


@pytest.mark.cuda
def test_shi_tomasi_kernel_matches_plain_on_card(cuda):
    """The four pyramid levels of a 640x480 image, and shapes that are
    no multiple of the kernel's 32x8 tile."""
    from ptam_cg_tpu_torch.ops import image as imops
    r = np.random.default_rng(1)
    im = torch.tensor(r.uniform(0, 255, (480, 640)), dtype=torch.float32,
                      device=cuda)
    extra = [torch.tensor(r.uniform(0, 255, s), dtype=torch.float32,
                          device=cuda) for s in ((37, 53), (9, 9), (61, 200))]
    for lev in list(imops.build_pyramid(im, 4)) + extra:
        before = kshi.launches
        got = kshi.shi_tomasi_score_map(lev)
        assert kshi.launches == before + 1
        torch.testing.assert_close(got, kshi.shi_tomasi_score_map_plain(lev),
                                   rtol=0, atol=0)
