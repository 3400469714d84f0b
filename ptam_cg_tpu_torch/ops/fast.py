"""FAST-10 corner detection, non-max suppression and fixed-capacity corner
lists (port of ``ptam_cg_tpu.ops.fast``).

The FAST score map (every level of a pyramid atlas in one launch, and the
plain one-image function) lives beside its Hopper kernel in
``kernels/fast.py``.
The corner lists follow ``jax.lax.top_k``'s order exactly: descending
score, equal scores in index order (a stable descending sort; ``torch.topk``
does not promise that order), and within a tile the first maximum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptam_cg_tpu_torch.kernels.fast import (  # noqa: F401
    ARC, CIRCLE, fast_atlas, fast_image, fast_score_map_plain)

Tensor = torch.Tensor


def nonmax_3x3(score: Tensor) -> Tensor:
    """3x3 non-max suppression mask: True where the score is positive and
    not below any neighbour; an earlier (row-major) neighbour may tie, a
    later one may not."""
    H, W = score.shape[-2:]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=float("-inf"))
    best = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb = p[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
            if (dy, dx) < (0, 0):
                best = best & (score >= nb)
            else:
                best = best & (score > nb)
    return best


class Corners(NamedTuple):
    """Fixed-capacity corner list."""

    xy: Tensor      # (N, 2) int32, (x, y); -1 where invalid
    score: Tensor   # (N,) float32; 0 where invalid
    valid: Tensor   # (N,) bool
    count: Tensor   # () int32


def _top_k(key: Tensor, k: int):
    """``jax.lax.top_k`` of a 1-D tensor: the k largest, ties in index
    order."""
    vals, idx = torch.sort(key, descending=True, stable=True)
    return vals[:k], idx[:k]


def corners_from_mask(mask: Tensor, score: Tensor, max_n: int,
                      tile: int = 1) -> Corners:
    """The ``max_n`` strongest corners of a dense mask. With ``tile`` > 1
    (and H, W divisible by it) only the best corner of each tile x tile
    block competes."""
    H, W = mask.shape
    key = torch.where(mask, score, float("-inf"))
    if tile > 1 and H % tile == 0 and W % tile == 0:
        Ht, Wt = H // tile, W // tile
        blocks = key.reshape(Ht, tile, Wt, tile).permute(0, 2, 1, 3)
        blocks = blocks.reshape(Ht, Wt, tile * tile)
        within = torch.argmax(blocks, dim=-1)             # the first maximum
        key = torch.amax(blocks, dim=-1)
        k = min(max_n, Ht * Wt)
        vals, idx = _top_k(key.reshape(-1), k)
        w = within.reshape(-1)[idx]
        ys = (idx // Wt) * tile + w // tile
        xs = (idx % Wt) * tile + w % tile
    else:
        k = min(max_n, H * W)
        vals, idx = _top_k(key.reshape(-1), k)
        ys = idx // W
        xs = idx % W
    if k < max_n:   # pad the capacity of small levels
        vals = torch.cat([vals, vals.new_full((max_n - k,), float("-inf"))])
        xs = torch.cat([xs, xs.new_zeros(max_n - k)])
        ys = torch.cat([ys, ys.new_zeros(max_n - k)])
    valid = vals > float("-inf")
    xy = torch.stack([xs, ys], dim=-1).to(torch.int32)
    xy = torch.where(valid[:, None], xy, -1)
    return Corners(xy=xy, score=torch.where(valid, vals, 0.0), valid=valid,
                   count=torch.sum(valid.to(torch.int32)))


def detect(im: Tensor, threshold: float, max_corners: int,
           nonmax: bool = True) -> tuple:
    """Full detection on one image: (corner mask, score map, Corners),
    FAST-10 through K1 (``fast_image``). With ``nonmax`` the mask and list
    are non-max suppressed (MakeKeyFrame_Rest, ref: src/KeyFrame.cc:64-66);
    without, the raw corners (MakeKeyFrame_Lite, src/KeyFrame.cc:35-42)."""
    is_corner, score = fast_image(im, threshold)
    keep = nonmax_3x3(score) & is_corner if nonmax else is_corner
    return keep, score, corners_from_mask(keep, score, max_corners)
