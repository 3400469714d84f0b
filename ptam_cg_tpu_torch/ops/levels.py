"""Pyramid-level coordinates and the packed pyramid atlas (port of
``ptam_cg_tpu.ops.levels``).

LevelZeroPos(p, l) = (p + 0.5) * 2^l - 0.5, as in the reference. The atlas
packs the 4 levels of a (H, W) image into one (1.5 H, W) image: level 0 at
(0, 0), level 1 at (H, 0), level 2 at (H, W/2), level 3 at (H, 3W/4).

Per-level tables are evaluated with ``torch.where`` over the level
tensor rather than by indexing a constant tensor, so no host-to-device
copy (and no stream sync) happens inside the tracking step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ptam_cg_tpu_torch.config import LEVELS

Tensor = torch.Tensor


def _select(level: Tensor, values: Sequence[float]) -> Tensor:
    """values[level] as float32, for a level tensor of any shape."""
    out = torch.full(level.shape, float(values[-1]), dtype=torch.float32,
                     device=level.device)
    for lev in range(len(values) - 2, -1, -1):
        out = torch.where(level == lev, float(values[lev]), out)
    return out


def level_scale(level: Tensor) -> Tensor:
    """2^level as float32."""
    return torch.bitwise_left_shift(torch.ones_like(level), level).to(
        torch.float32)


def _broadcast_scale(p: Tensor, level: Tensor) -> Tensor:
    s = level_scale(level)
    if s.ndim == p.ndim - 1:
        s = s[..., None]
    return s


def level_zero_pos(p: Tensor, level: Tensor) -> Tensor:
    """Level-l coords -> level-0 coords."""
    return (p + 0.5) * _broadcast_scale(p, level) - 0.5


def level_n_pos(p: Tensor, level: Tensor) -> Tensor:
    """Level-0 coords -> level-l coords."""
    return (p + 0.5) / _broadcast_scale(p, level) - 0.5


def atlas_shape(h: int, w: int) -> Tuple[int, int]:
    if h % 8 or w % 8:
        raise ValueError(f"image dims must be divisible by 8, got {h}x{w}")
    return (h + h // 2, w)


def level_offsets(h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    """(row, col) of each level's top-left pixel in the atlas."""
    return ((0, 0), (h, 0), (h, w // 2), (h, w // 2 + w // 4))


def level_sizes(h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((h >> lev, w >> lev) for lev in range(LEVELS))


def pack_atlas(pyramid: Sequence[Tensor]) -> Tensor:
    """Pack a 4-level pyramid (any dtype) into the atlas layout."""
    h, w = pyramid[0].shape
    A = pyramid[0].new_zeros(atlas_shape(h, w))
    for (r, c), lev in zip(level_offsets(h, w), pyramid):
        A[r: r + lev.shape[0], c: c + lev.shape[1]] = lev
    return A


def build_atlas(im: Tensor) -> Tensor:
    """Level-0 image -> packed pyramid atlas (MakeKeyFrame_Lite's
    pyramid, ref: src/KeyFrame.cc:23-33)."""
    # Imported here: ops.image imports the kernels, which import this
    # module.
    from ptam_cg_tpu_torch.ops import image as imops
    return pack_atlas(imops.build_pyramid(im, LEVELS))


def unpack_level(atlas: Tensor, level: int, h: int, w: int) -> Tensor:
    r, c = level_offsets(h, w)[level]
    return atlas[r: r + (h >> level), c: c + (w >> level)]


def _offset_xy(level: Tensor, h: int, w: int):
    offs = level_offsets(h, w)
    return (_select(level, [c for (_, c) in offs]),
            _select(level, [r for (r, _) in offs]))


def atlas_pos(p_level_xy: Tensor, level: Tensor, h: int, w: int) -> Tensor:
    """(x, y) in level-l coords -> (x, y) in atlas coords."""
    ox, oy = _offset_xy(level, h, w)
    return p_level_xy + torch.stack([ox, oy], dim=-1)


def level_bounds(level: Tensor, h: int, w: int):
    """(x0, y0, x1, y1) atlas-coordinate bounds of each point's level."""
    ox, oy = _offset_xy(level, h, w)
    sizes = level_sizes(h, w)
    sw = _select(level, [wl for (_, wl) in sizes])
    sh = _select(level, [hl for (hl, _) in sizes])
    return ox, oy, ox + sw, oy + sh
