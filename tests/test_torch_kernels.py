"""K1 (FAST-10), K2 (window gather) and K3 (Shi-Tomasi): plain versions
against the JAX package, and kernels against plain versions on the card
(K3's plain version is held to the JAX package in test_torch_keyframe.py).

Bars: bit-identical everywhere. FAST uses only f32 add, subtract, min and
max; the gather is a copy; K3 rounds every operation on its own in the
plain version's order. K1's atlas-wide entry is held to the JAX
package's ``make_frame_lite`` (mask atlas, scores, counts), and on an
atlas whose levels have bright dots in their borders and in the unused
area, where evaluating a level's edge or reading a neighbouring level
would make corners. K2's pair entry and its int64 origin columns are
held to ``gather_windows_rowtake``. K3's atlas entry takes the same two
atlases on the card. The card tests carry the ``cuda``
marker and skip without a GPU. A GPU machine need not have JAX, so the
JAX references load through the ``jax_ref`` fixture and the card tests
run with ``python -m pytest tests/test_torch_kernels.py -m cuda
--noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch.config import FrontendConfig
from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.kernels import fast as kfast
from ptam_cg_tpu_torch.kernels import gather as kgather
from ptam_cg_tpu_torch.kernels import shi_tomasi as kshi
from ptam_cg_tpu_torch.ops import image as timops
from ptam_cg_tpu_torch.ops import levels as tlevelops

torch.set_num_threads(2)

#: The window sides on the tracking path: search windows 40 (coarse) and
#: 30 (fine), corner-mask windows 33 and 23, template windows 28; on the
#: keyframe path: epipolar patches 8, re-find corner-mask windows 9,
#: sub-pixel windows 15 and re-find search windows 16; on the bootstrap
#: path: trail search windows 29 (MiniPatch cuts 9, template cuts 8).
PATH_WINDOWS = (8, 9, 15, 16, 23, 28, 29, 30, 33, 40)
REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
THRESHOLDS = FrontendConfig().fast_thresholds


@pytest.fixture(scope="module")
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from ptam_cg_tpu.models import keyframe
    from ptam_cg_tpu.ops import fast, levels, pallas_gather, pallas_kernels
    return types.SimpleNamespace(jnp=jnp, fast=fast, pg=pallas_gather,
                                 pk=pallas_kernels, keyframe=keyframe,
                                 levels=levels)


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
    mask, score = kfast.fast_score_map_plain(torch.from_numpy(im), threshold)
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


def _columns(org):
    """The (oy, ox) column views of an (N, 2) origin tensor."""
    return org[:, 0], org[:, 1]


@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_plain_matches_jax(jax_ref, D):
    jnp, pg = jax_ref.jnp, jax_ref.pg
    atlas, inside, edges = _atlas_and_origins(D, D)
    got = kgather.gather_windows(torch.from_numpy(atlas),
                                 *_columns(torch.from_numpy(inside)), D)
    ref = pg.gather_windows_pallas(jnp.asarray(atlas), jnp.asarray(inside), D,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    both = np.concatenate([inside, edges])
    got = kgather.gather_windows(torch.from_numpy(atlas),
                                 *_columns(torch.from_numpy(both)), D)
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
                                 *_columns(torch.from_numpy(origins)), D)
    ref = pg.gather_windows_rowtake(jnp.asarray(mask.astype(np.float32)),
                                    jnp.asarray(origins), D) > 0.5
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _frame(size):
    seq = tsynth.SyntheticSequence(REF_PARAMS, image_size=size, n_frames=2,
                                   seed=7, height=1.5, radius=0.2, sweep=0.6,
                                   device="cpu")
    return seq.frame(1).numpy()


def _bordered_atlas(size, seed):
    """A pyramid atlas whose levels hold noise inside a 3-px border of 0
    with bright dots (255) one pixel in from each edge, in an unused area
    of 0 with bright dots: each dot is a FAST corner to any version that
    evaluates pixels near a level's edge or reads across it."""
    w, h = size
    r = np.random.default_rng(seed)
    atlas = np.where(r.uniform(size=tlevelops.atlas_shape(h, w)) < 0.01,
                     255.0, 0.0).astype(np.float32)
    for (r0, c0, hl, wl) in kfast.level_rects(atlas.shape):
        lev = np.zeros((hl, wl), np.float32)
        lev[3:-3, 3:-3] = r.uniform(0, 120, (hl - 6, wl - 6))
        lev[[1, -2], 2:-2:5] = 255.0
        lev[2:-2:5, [1, -2]] = 255.0
        atlas[r0: r0 + hl, c0: c0 + wl] = lev
    return atlas


def _fast_atlas_ref(jax_ref, atlas):
    """The JAX package's per-level FAST on the levels of an atlas, packed
    as its ``make_frame_lite`` packs them."""
    jnp, lv = jax_ref.jnp, jax_ref.levels
    maps = [jax_ref.fast.fast_score_map(
        jnp.asarray(atlas[r0: r0 + hl, c0: c0 + wl]), float(t))
        for (r0, c0, hl, wl), t in zip(kfast.level_rects(atlas.shape),
                                       THRESHOLDS)]
    mask = lv.pack_atlas(tuple(m.astype(jnp.float32) for m, _ in maps)) > 0.5
    return (np.asarray(mask), np.asarray(lv.pack_atlas(tuple(
        s for _, s in maps))), np.array([int(m.sum()) for m, _ in maps]))


def test_fast_atlas_plain_matches_jax_make_frame_lite(jax_ref):
    """A 320x240 frame: the mask atlas, the per-level scores and the
    counts of the JAX package's ``make_frame_lite``, bit for bit."""
    frame = _frame((320, 240))
    _, j_atlas, j_mask, j_scores, j_counts = jax_ref.keyframe.make_frame_lite(
        jax_ref.jnp.asarray(frame))
    atlas = tlevelops.pack_atlas(timops.build_pyramid(
        torch.from_numpy(frame), 4))
    np.testing.assert_array_equal(atlas.numpy(), np.asarray(j_atlas))
    mask, score, counts = kfast.fast_atlas(atlas, THRESHOLDS, scores=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    for lev, ref in enumerate(j_scores):
        np.testing.assert_array_equal(
            tlevelops.unpack_level(score, lev, 240, 320).numpy(),
            np.asarray(ref))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert (counts > 0).all()
    alone = kfast.fast_atlas(atlas, THRESHOLDS)
    assert alone[1] is None and alone[2] is None
    assert torch.equal(alone[0], mask)


def test_fast_atlas_plain_reads_no_neighbouring_level(jax_ref):
    """Levels with bright borders side by side in the atlas: the result is
    the JAX package's per-level FAST (zero padding at each level's edge),
    the unused area is False, and FAST over the atlas as one image (which
    reads across level edges) would differ."""
    atlas = _bordered_atlas((320, 240), 4)
    ref_mask, ref_score, ref_counts = _fast_atlas_ref(jax_ref, atlas)
    mask, score, counts = kfast.fast_atlas(torch.from_numpy(atlas),
                                           THRESHOLDS, scores=True)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(score.numpy(), ref_score)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    inside = np.zeros(atlas.shape, bool)
    for (r0, c0, hl, wl) in kfast.level_rects(atlas.shape):
        inside[r0 + 3: r0 + hl - 3, c0 + 3: c0 + wl - 3] = True
    assert ref_mask.any() and not mask.numpy()[~inside].any()
    whole, _ = kfast.fast_score_map_plain(torch.from_numpy(atlas), 10.0)
    assert whole.numpy()[~inside].any()


@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_pair_and_int64_origins_match_rowtake(jax_ref, D):
    """The pair entry (image window D at the origins, mask window D-7 at
    the origins + 4, as ``ssd_search`` gathers them) and the single entry
    with int64 origins, as strided column views and as contiguous
    columns."""
    jnp, pg = jax_ref.jnp, jax_ref.pg
    atlas, inside, edges = _atlas_and_origins(D, D + 100)
    mask = atlas > 128.0
    org = np.concatenate([inside, edges]).astype(np.int64)
    M = max(D - 7, 2)
    ref = np.asarray(pg.gather_windows_rowtake(jnp.asarray(atlas),
                                               jnp.asarray(org), D))
    ref_m = np.asarray(pg.gather_windows_rowtake(
        jnp.asarray(mask.astype(np.float32)), jnp.asarray(org + 4), M)) > 0.5
    t_org = torch.from_numpy(org)
    for origins in (_columns(t_org),
                    (t_org[:, 0].clone(), t_org[:, 1].clone())):
        got = kgather.gather_windows(torch.from_numpy(atlas), *origins, D)
        np.testing.assert_array_equal(got.numpy(), ref)
        win, mwin = kgather.gather_window_pair(
            torch.from_numpy(atlas), torch.from_numpy(mask), *origins, D, 4,
            M)
        np.testing.assert_array_equal(win.numpy(), ref)
        assert mwin.dtype == torch.bool
        np.testing.assert_array_equal(mwin.numpy(), ref_m)


def test_build_defines_change_library_name():
    """A variant build (``-D`` defines) gets a library of its own; the
    defines are in its name and hash."""
    base = _build.library_path("shi_tomasi")
    tall = _build.library_path("shi_tomasi", ("ST_TILE_H=32",))
    wide = _build.library_path("shi_tomasi", ("ST_TILE_W=128", "ST_PX=4"))
    assert base.name.startswith("libshi_tomasi-")
    assert tall.name.startswith("libshi_tomasi-ST_TILE_H=32-")
    assert wide.name.startswith("libshi_tomasi-ST_TILE_W=128-ST_PX=4-")
    assert len({base, tall, wide}) == 3
    assert len({p.name.rsplit("-", 1)[1] for p in (base, tall, wide)}) == 3
    assert _build.library_path("shi_tomasi", ("ST_TILE_H=32",)) == tall
    with pytest.raises(ValueError):
        _build.library_path("shi_tomasi", ("ST_TILE_H=32; rm",))


def test_shi_tomasi_atlas_rejects_what_the_kernel_cannot_take():
    """No fallback: a device other than the CPU or the card, another
    dtype or a shape that is no pyramid atlas raises."""
    with pytest.raises(ValueError):
        kshi.shi_tomasi_atlas(torch.empty((360, 320), device="meta"))
    with pytest.raises(ValueError):
        kshi.shi_tomasi_atlas(torch.zeros((359, 320)))
    before = kshi.launches
    cpu = kshi.shi_tomasi_atlas(torch.zeros((360, 320)))
    assert kshi.launches == before and not cpu.any()


@pytest.mark.cuda
def test_fast_kernel_matches_plain_on_card(cuda):
    """All four pyramid levels of a 640x480 image, at the frontend's
    thresholds: each level's view of the kernel's atlas outputs equals the
    single-image plain version on that level."""
    im = np.random.default_rng(0).uniform(0, 255, (480, 640))
    pyr = timops.build_pyramid(torch.tensor(im, dtype=torch.float32,
                                            device=cuda), 4)
    before = kfast.launches
    mask, score, _ = kfast.fast_atlas(tlevelops.pack_atlas(pyr), THRESHOLDS,
                                      scores=True)
    assert kfast.launches == before + 1
    for lev, (im_l, t) in enumerate(zip(pyr, THRESHOLDS)):
        m_p, s_p = kfast.fast_score_map_plain(im_l, float(t))
        torch.testing.assert_close(
            tlevelops.unpack_level(mask, lev, 480, 640), m_p, rtol=0, atol=0)
        torch.testing.assert_close(
            tlevelops.unpack_level(score, lev, 480, 640), s_p, rtol=0, atol=0)


def _atlas_cases(cuda):
    """(name, atlas) on the card: the bright-border atlas of a 320x240
    frame and the atlas of a 640x480 frame."""
    big = torch.tensor(np.random.default_rng(2).uniform(0, 255, (480, 640)),
                       dtype=torch.float32, device=cuda)
    return [("bordered", torch.from_numpy(_bordered_atlas((320, 240),
                                                          4)).to(cuda)),
            ("640x480", tlevelops.pack_atlas(timops.build_pyramid(big, 4)))]


@pytest.mark.cuda
def test_fast_atlas_kernel_matches_plain_on_card(cuda):
    """One launch per call; mask, scores and counts bit-identical, with
    and without the scores and counts."""
    for name, atlas in _atlas_cases(cuda):
        ref = kfast.fast_atlas_plain(atlas, THRESHOLDS, scores=True)
        for scores in (False, True):
            before = kfast.launches
            got = kfast.fast_atlas(atlas, THRESHOLDS, scores=scores)
            assert kfast.launches == before + 1
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
            for g, r in zip(got[1:], ref[1:]):
                if scores:
                    torch.testing.assert_close(g, r, rtol=0, atol=0)
                else:
                    assert g is None
        assert int(ref[2].sum()) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_pair_kernel_matches_plain_on_card(cuda, D):
    """One launch per pair; int32 and int64 origins, as strided column
    views and as contiguous columns."""
    atlas, inside, edges = _atlas_and_origins(D, D)
    a = torch.from_numpy(atlas).to(cuda)
    m = a > 128.0
    M = max(D - 7, 2)
    for dtype in (torch.int32, torch.int64):
        org = torch.from_numpy(np.concatenate([inside, edges])).to(
            cuda, dtype)
        ref = kgather.gather_window_pair_plain(a, m, *_columns(org), D, 4, M)
        for origins in (_columns(org),
                        (org[:, 0].contiguous(), org[:, 1].contiguous())):
            before = kgather.launches
            win, mwin = kgather.gather_window_pair(a, m, *origins, D, 4, M)
            assert kgather.launches == before + 1
            torch.testing.assert_close(win, ref[0], rtol=0, atol=0)
            torch.testing.assert_close(mwin, ref[1], rtol=0, atol=0)
            got = kgather.gather_windows(a, *origins, D)
            torch.testing.assert_close(got, ref[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", PATH_WINDOWS)
def test_gather_kernel_matches_plain_on_card(cuda, D):
    atlas, inside, edges = _atlas_and_origins(D, D)
    origins = _columns(torch.from_numpy(np.concatenate([inside,
                                                        edges])).to(cuda))
    for a in (torch.from_numpy(atlas), torch.from_numpy(atlas > 128.0),
              torch.from_numpy(atlas.astype(np.uint8))):
        a = a.to(cuda)
        before = kgather.launches
        got = kgather.gather_windows(a, *origins, D)
        assert kgather.launches == before + 1
        torch.testing.assert_close(got, kgather.gather_windows_plain(
            a, *origins, D), rtol=0, atol=0)


@pytest.mark.cuda
def test_shi_tomasi_kernel_matches_plain_on_card(cuda):
    """One launch per call over the whole atlas, bit-identical; the 360
    rows of the 320x240 frame's atlas are no multiple of the kernel's
    16-row tile."""
    for name, atlas in _atlas_cases(cuda):
        before = kshi.launches
        got = kshi.shi_tomasi_atlas(atlas)
        assert kshi.launches == before + 1
        ref = kshi.shi_tomasi_atlas_plain(atlas)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert int((ref > 50.0).sum()) > 0, name
