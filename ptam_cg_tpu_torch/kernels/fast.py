"""K1: FAST-10 corner mask, score and corner counts (``csrc/fast10.cu``).

Replaces the TPU kernels ``ptam_cg_tpu/ops/pallas_kernels.py``
``fast_score_map_banded`` and ``fast_score_map_pallas``; the function is
``ptam_cg_tpu/ops/fast.py::fast_score_map`` on each pyramid level.

``fast_atlas`` runs all four levels of a packed pyramid atlas in one
launch: the corner mask comes out in the atlas layout (False outside the
levels); only when asked, the score (score+t at corners, 0 elsewhere)
into an atlas-shaped buffer and the per-level corner counts, from one
integer atomic add per block and level. It runs the plain version for a
CPU tensor and the kernel for a CUDA tensor, bit-identical either way:
the function uses only f32 add, subtract, min and max.
``fast_score_map_plain`` is the single-image function, the plain version
of each level. ``fast_image`` runs the kernel on one image, as a table of
one level covering it (the other three empty): ``ops/fast.detect``.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional, Sequence, Tuple

import torch

from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.ops import levels as levelops

Tensor = torch.Tensor

ARC = 10  # FAST-10

#: FAST ring offsets (x, y), clockwise from 12 o'clock.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

#: Kernel launches made by ``fast_atlas`` and ``fast_image`` in this
#: process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}


def fast_score_map_plain(im: Tensor, threshold: float):
    """Plain PyTorch FAST-10: (is_corner (H, W) bool, score (H, W) f32)."""
    im = im.to(torch.float32)
    H, W = im.shape
    pad = 3
    p = torch.nn.functional.pad(im, (pad, pad, pad, pad))
    ring = [p[pad + dy: pad + dy + H, pad + dx: pad + dx + W]
            for dx, dy in CIRCLE]
    ring = ring + ring[: ARC - 1]
    hi = im + threshold
    lo = im - threshold

    def arc_max(margins):
        best = None
        for s in range(16):
            m = margins[s]
            for k in range(1, ARC):
                m = torch.minimum(m, margins[s + k])
            best = m if best is None else torch.maximum(best, m)
        return best

    score = torch.maximum(arc_max([r - hi for r in ring]),
                          arc_max([lo - r for r in ring]))
    inner = torch.zeros((H, W), dtype=torch.bool, device=im.device)
    inner[pad:-pad, pad:-pad] = True
    is_corner = (score > 0.0) & inner
    return is_corner, torch.where(is_corner, score + threshold, 0.0)


def level_rects(atlas_shape: Tuple[int, int]):
    """(row, col, height, width) of each level in an atlas of this shape."""
    Ha, W = atlas_shape
    if Ha % 3 or (2 * Ha // 3) % 8 or W % 8:
        raise ValueError(f"not a pyramid atlas shape: {Ha}x{W}")
    h = 2 * Ha // 3
    return tuple((r, c, hl, wl) for (r, c), (hl, wl) in zip(
        levelops.level_offsets(h, W), levelops.level_sizes(h, W)))


def fast_atlas_plain(atlas: Tensor, thresholds: Sequence[float], *,
                     scores: bool = False):
    """Plain version of ``fast_atlas``: ``fast_score_map_plain`` on each
    level's view, packed into the atlas layout."""
    mask = torch.zeros(atlas.shape, dtype=torch.bool, device=atlas.device)
    score = torch.zeros(atlas.shape, dtype=torch.float32,
                        device=atlas.device) if scores else None
    n = []
    for (r, c, hl, wl), t in zip(level_rects(atlas.shape), thresholds):
        m, s = fast_score_map_plain(atlas[r: r + hl, c: c + wl], float(t))
        mask[r: r + hl, c: c + wl] = m
        if scores:
            score[r: r + hl, c: c + wl] = s
        n.append(torch.sum(m, dtype=torch.int32))
    return mask, score, torch.stack(n) if scores else None


def _lib():
    fn = _build.load("fast10").fast10_atlas
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fast_atlas(atlas: Tensor, thresholds: Sequence[float], *,
               scores: bool = False
               ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """FAST-10 on every level of a (1.5 H, W) float32 pyramid atlas, one
    threshold per level. Returns (corner mask (Ha, W) bool, the score
    atlas (Ha, W) float32, per-level corner counts (LEVELS,) int32); the
    last two only with ``scores``, else None."""
    if atlas.device.type == "cpu":
        return fast_atlas_plain(atlas, thresholds, scores=scores)
    rects = level_rects(atlas.shape)
    if len(thresholds) != len(rects):
        raise ValueError(f"fast_atlas: {len(thresholds)} thresholds for "
                         f"{len(rects)} levels")
    return _launch(atlas, rects, thresholds, scores, "fast_atlas")


def fast_image(im: Tensor, threshold: float) -> Tuple[Tensor, Tensor]:
    """FAST-10 on one (H, W) float32 image: (is_corner (H, W) bool, score
    (H, W) float32), ``fast_score_map_plain``'s. The kernel's level table
    holds one level covering the image and three empty ones."""
    if im.device.type == "cpu":
        return fast_score_map_plain(im, threshold)
    H, W = im.shape
    rects = ((0, 0, H, W),) + ((0, 0, 0, 0),) * (levelops.LEVELS - 1)
    mask, score, _ = _launch(im, rects, (float(threshold),) * len(rects),
                             True, "fast_image")
    return mask, score


def _launch(atlas: Tensor, rects, thresholds, scores: bool, what: str):
    """One K1 launch over ``atlas`` with the level table ``rects`` (4
    (row, col, height, width)) and a threshold a level."""
    if atlas.device.type != "cuda" or atlas.dtype != torch.float32 or \
            atlas.ndim != 2:
        raise ValueError(f"{what}: need a 2-D float32 CUDA image, got "
                         f"{tuple(atlas.shape)} {atlas.dtype} on "
                         f"{atlas.device}")
    atlas = atlas.contiguous()
    Ha, Wa = atlas.shape
    if Wa % 4 or atlas.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel reads 16-byte rows; width "
                         f"{Wa} is no multiple of 4 or the data unaligned")
    n = len(rects)
    flat = [int(v) for rect in rects for v in rect]
    mask = torch.empty((Ha, Wa), dtype=torch.bool, device=atlas.device)
    sc = cnt = None
    if scores:
        sc = torch.empty((Ha, Wa), dtype=torch.float32, device=atlas.device)
        cnt = torch.zeros(n, dtype=torch.int32, device=atlas.device)
    fn = _lib()
    stream = _build.stream_handle(atlas)
    _build.count_launch(sys.modules[__name__], stream)
    _build.check(fn(atlas.data_ptr(), Ha, Wa,
                    (ctypes.c_int * len(flat))(*flat),
                    (ctypes.c_float * n)(*[float(t) for t in thresholds]),
                    mask.data_ptr(), 0 if sc is None else sc.data_ptr(),
                    0 if cnt is None else cnt.data_ptr(),
                    stream), what)
    return mask, sc, cnt
