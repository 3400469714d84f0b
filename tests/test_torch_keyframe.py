"""The keyframe build: non-max suppression, corner lists, the Shi-Tomasi
score (the plain version of kernel K3, on one image and over a pyramid
atlas) and ``build_frame``, the PyTorch port against the JAX package on
the same seeded inputs.

Bars and why:
- ``nonmax_3x3`` and ``corners_from_mask`` are exact, the order of the
  lists included: they compare and sort only. Ties (integer scores) must
  fall in index order, as ``jax.lax.top_k`` puts them;
- the Shi-Tomasi score sums in the order of the banded TPU kernel, with
  every operation rounded on its own. ``shi_tomasi_banded(interpret=True)``
  runs as one XLA program on the CPU, which rounds differently inside its
  fused loops (fused multiply-adds in the discriminant account for half of
  the differing pixels); an eager replay of its body, op by op, matches
  the port bit for bit. Where the two eigenvalues nearly tie, the
  discriminant cancels and that rounding shows: the bar is 1e-5 of the
  score plus 3e-5 of the trace dxx + dyy (measured: 1.6e-5 of the trace
  at most).
  Against the JAX package's cumsum form ``shi_tomasi_score_map`` the bar
  is the JAX package's own between its two forms, rtol 2e-4 and atol 0.5
  (tests/test_fast.py). Over an atlas, each level's view is held to the
  JAX package's score of that level alone at the same bars, and the rest
  of the atlas is 0;
- ``build_frame``: atlas, corner mask, counts and non-max lists exact;
  candidate lists equal except for entries whose score lies within the
  cumsum bar of the threshold or of the capacity cut-off; SBIs within
  1e-3 (blur sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.models import keyframe
from ptam_cg_tpu.ops import fast as fastops
from ptam_cg_tpu.ops import image as imops
from ptam_cg_tpu.ops import pallas_kernels
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.kernels import fast as kfast
from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi
from ptam_cg_tpu_torch.models import keyframe as tkeyframe
from ptam_cg_tpu_torch.ops import fast as tfast
from ptam_cg_tpu_torch.ops import image as timops
from ptam_cg_tpu_torch.ops import levels as tlevelops
from test_torch_kernels import _bordered_atlas

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
CAND_MIN = 50.0
ST_RTOL, ST_ATOL = 2e-4, 0.5     # the JAX package's bar between its forms

_nonmax_ref = jax.jit(fastops.nonmax_3x3)
_corners_ref = jax.jit(fastops.corners_from_mask, static_argnums=(2, 3))


def _tied_scores(shape, seed):
    """Integer scores in steps of 10, half of them zero: many ties between
    neighbours and across the list."""
    r = np.random.default_rng(seed)
    s = (r.integers(1, 6, shape) * 10).astype(np.float32)
    s[r.uniform(size=shape) < 0.5] = 0.0
    return s


@pytest.fixture(scope="module")
def frame():
    seq = tsynth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=4,
                                   seed=7, height=1.5, radius=0.2, sweep=0.6,
                                   device="cpu")
    return seq.frame(1).numpy()


def test_nonmax_3x3_matches_jax():
    s = _tied_scores((60, 80), 0)
    keep = tfast.nonmax_3x3(torch.from_numpy(s))
    ref = np.asarray(_nonmax_ref(jnp.asarray(s)))
    np.testing.assert_array_equal(keep.numpy(), ref)
    assert 0 < ref.sum() < (s > 0).sum()


@pytest.mark.parametrize("shape,tile,max_n", [
    ((60, 80), 2, 2048),     # level 3 at 640x480: 1,200 tiles, padded
    ((30, 40), 1, 2048),     # fewer pixels than the capacity: padded
    ((120, 160), 2, 512),    # capacity cut-off inside a run of ties
    ((120, 160), 1, 256),
    ((61, 81), 2, 512),      # a tile that does not divide: untiled
])
def test_corners_from_mask_matches_jax(shape, tile, max_n):
    s = _tied_scores(shape, shape[0] + tile)
    mask = tfast.nonmax_3x3(torch.from_numpy(s))
    got = tfast.corners_from_mask(mask, torch.from_numpy(s), max_n, tile=tile)
    ref = _corners_ref(jnp.asarray(mask.numpy()), jnp.asarray(s), max_n, tile)
    for f in ("xy", "score", "valid", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(got.count) > 0


def _shi_inputs(frame):
    noise = np.random.default_rng(1).uniform(0, 255, (37, 53))
    pyr = timops.build_pyramid(torch.from_numpy(frame), 4)
    return [p.numpy() for p in pyr] + [noise.astype(np.float32)]


def _trace(im):
    """dxx + dyy of the score: the scale of its cancellation."""
    gx = np.zeros_like(im)
    gy = np.zeros_like(im)
    gx[:, 1:-1] = im[:, 2:] - im[:, :-2]
    gy[1:-1] = im[2:] - im[:-2]
    box = timops.box_sum(torch.from_numpy(gx * gx + gy * gy), 3).numpy()
    return box / 98.0


def _assert_matches_jax_shi_tomasi(got, im, cumsum=True, cancel=False):
    """``got`` against the banded TPU kernel (interpret mode) on ``im`` at
    1e-5 of the score plus 3e-5 of the trace, and against the cumsum form
    at the JAX package's own bar. With ``cancel`` the first bar also takes
    the float32 rounding of the discriminant tr^2 - 4 det, a few ulps of
    tr^2 (8 eps tr^2 = e), which moves the root by e / (2 root), at most
    sqrt(e): where the eigenvalues nearly tie, as on uniform noise, the
    root is small and that term dominates."""
    banded = np.asarray(pallas_kernels.shi_tomasi_banded(
        jnp.asarray(im), half_box=3, interpret=True))
    tr = _trace(im)
    bar = 1e-5 * np.abs(banded) + 3e-5 * tr
    if cancel:
        e = 8 * np.finfo(np.float32).eps * tr.astype(np.float64) ** 2
        root = np.maximum(tr - 2.0 * banded, 0.0)
        bar = bar + 0.5 * np.minimum(np.sqrt(e), e / np.maximum(2 * root,
                                                                1e-30))
    excess = np.abs(got - banded) - bar
    assert excess.max() <= 0, (im.shape, excess.max())
    if cumsum:
        ref = np.asarray(jax.jit(imops.shi_tomasi_score_map)(jnp.asarray(im)))
        np.testing.assert_allclose(got, ref, rtol=ST_RTOL, atol=ST_ATOL)


def test_shi_tomasi_plain_matches_jax(frame):
    """The four pyramid levels of a 320x240 frame and a noise image of an
    odd shape."""
    for im in _shi_inputs(frame):
        got = timops.shi_tomasi_score_map(torch.from_numpy(im)).numpy()
        _assert_matches_jax_shi_tomasi(got, im)
        assert (got > CAND_MIN).sum() > 10


def _levels_and_rest(atlas, score):
    """Each level's view of ``score`` and of ``atlas``, and the mask of
    the atlas outside the levels' inner pixels."""
    outside = np.ones(atlas.shape, bool)
    views = []
    for r0, c0, hl, wl in kfast.level_rects(atlas.shape):
        views.append((score[r0: r0 + hl, c0: c0 + wl],
                      atlas[r0: r0 + hl, c0: c0 + wl]))
        outside[r0 + 4: r0 + hl - 4, c0 + 4: c0 + wl - 4] = False
    return views, outside


def test_shi_tomasi_atlas_plain_matches_jax(frame):
    """A 320x240 frame's pyramid atlas: each level's view is the JAX
    package's score of that level, and the rest of the atlas is 0."""
    atlas = tlevelops.pack_atlas(timops.build_pyramid(
        torch.from_numpy(frame), 4))
    score = kshi.shi_tomasi_atlas(atlas)             # a CPU tensor: plain
    assert score.shape == atlas.shape and score.dtype == torch.float32
    views, outside = _levels_and_rest(atlas.numpy(), score.numpy())
    for got, im in views:
        _assert_matches_jax_shi_tomasi(got, im)
        np.testing.assert_array_equal(
            got, kshi.shi_tomasi_score_map_plain(torch.from_numpy(im)))
    assert not score.numpy()[outside].any()
    assert (score > CAND_MIN).sum() > 100


def test_shi_tomasi_atlas_plain_reads_no_neighbouring_level():
    """Levels with bright borders side by side, and bright dots in the
    unused area: each level's view is the JAX package's score of that
    level alone (zero padding at its edges) and the rest is 0, where the
    score of the atlas as one image (which reads across level edges) is
    not. A score at least 4 px inside a level reads that level alone, so
    there the two agree."""
    atlas = _bordered_atlas((320, 240), 4)
    score = kshi.shi_tomasi_atlas_plain(torch.from_numpy(atlas)).numpy()
    views, outside = _levels_and_rest(atlas, score)
    for got, im in views:
        np.testing.assert_array_equal(
            got, kshi.shi_tomasi_score_map_plain(torch.from_numpy(im)))
        _assert_matches_jax_shi_tomasi(got, im, cancel=True)
    assert not score[outside].any()
    whole = kshi.shi_tomasi_score_map_plain(torch.from_numpy(atlas)).numpy()
    assert (whole[outside] > CAND_MIN).any()
    np.testing.assert_array_equal(whole[~outside], score[~outside])


def _near(s, level):
    return abs(s - level) <= ST_ATOL + ST_RTOL * abs(level)


def test_build_frame_matches_jax(frame):
    """Against the eager JAX build: under jit XLA regroups the pyramid's
    level-2/3 sums (see tests/test_torch_ops.py)."""
    ref = keyframe.build_frame(jnp.asarray(frame),
                               candidate_min_score=CAND_MIN)
    got = tkeyframe.build_frame(torch.from_numpy(frame),
                                candidate_min_score=CAND_MIN)
    for f in ("atlas", "corner_mask", "corner_count", "max_xy", "max_score",
              "max_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for name in ("sbi", "sbi_track"):
        for f in ("template", "jac"):
            np.testing.assert_allclose(
                getattr(getattr(got, name), f).numpy(),
                np.asarray(getattr(getattr(ref, name), f)), atol=1e-3)

    unexplained, n_cands = [], 0
    for lev in range(4):
        lists = []
        for ff in (got, ref):
            xy = np.asarray(ff.cand_xy[lev])
            sc = np.asarray(ff.cand_score[lev])
            ok = np.asarray(ff.cand_valid[lev])
            lists.append({tuple(p): s for p, s, v in zip(xy, sc, ok) if v})
        mine, theirs = lists
        n_cands += len(theirs)
        full = len(theirs) == tkeyframe.CAND_CAP
        cutoff = min(theirs.values()) if full else None
        for p in set(mine) | set(theirs):
            if p in mine and p in theirs:
                assert _near(mine[p], theirs[p]), (lev, p, mine[p], theirs[p])
                continue
            s = mine.get(p, theirs.get(p))
            if not (_near(s, CAND_MIN) or (full and _near(s, cutoff))):
                unexplained.append((lev, p, s, "port" if p in mine else "jax"))
        # The port's list is in descending score order.
        sc = got.cand_score[lev][got.cand_valid[lev]].numpy()
        assert np.all(np.diff(sc) <= 0), lev
    assert n_cands > 100
    assert not unexplained, unexplained
