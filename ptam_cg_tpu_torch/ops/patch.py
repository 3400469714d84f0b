"""Batched patch search (port of ``ptam_cg_tpu.ops.patch``).

1. ``search_level_and_warp``: warp matrix and search level per point.
2. ``make_warped_templates``: one 28x28 window per point from its source
   keyframe atlas (kernel K2), then the 8x8 bilinear template read from
   it with direct 4-tap loads. The JAX package samples the window with
   one-hot matmuls; the window gate ``in_win`` it implies is kept, since
   it changes which points are attempted. ``make_warped_templates_flat``
   is the JAX package's other formulation: four flat-index taps a sample
   straight from the atlases, with no window and no window gate.
3. ``ssd_search``: dense windowed ZMSSD over (2r+1)^2 candidates from one
   image window and one corner-mask window per point (one K2 launch);
   with ``bf16_cross`` the cross term reads the templates and windows
   rounded to bfloat16 (``TrackerConfig.zmssd_bf16_cross``).
4. ``subpix_refine``: inverse-composition refinement on the search
   windows, or on windows it gathers from the atlas (K2), re-based with a
   direct indexed load (the JAX package uses a one-hot blend); the loop
   lives beside its Hopper kernel (K6) in ``kernels/subpix.py``.

Positions are atlas coordinates unless noted.
"""

from __future__ import annotations

import dataclasses

import torch

from ptam_cg_tpu_torch.config import LEVELS, PATCH_SIZE
from ptam_cg_tpu_torch.kernels import subpix as ksubpix
from ptam_cg_tpu_torch.ops.gather import gather_window_pair, gather_windows

Tensor = torch.Tensor

#: The masked-candidate score: larger than any real ZMSSD.
BIG = 3.4e38


@dataclasses.dataclass
class WarpResult:
    warp_inv: Tensor   # (N, 2, 2) level-0 pixels per source pixel
    level: Tensor      # (N,) int64 chosen search level
    good: Tensor       # (N,) bool: det in [0.25, 3] at the chosen level


def search_level_and_warp(p_cam: Tensor, R_cw: Tensor, pixel_right_w: Tensor,
                          pixel_down_w: Tensor,
                          cam_derivs: Tensor) -> WarpResult:
    """Vectorized CalcSearchLevelAndWarpMatrix."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)

    def col(motion_w):
        m = motion_w @ R_cw.T
        v = (m[..., :2] - p_cam[..., :2] * (m[..., 2] * inv_z)[..., None])
        v = v * inv_z[..., None]
        return (cam_derivs @ v[..., None])[..., 0]

    c0 = col(pixel_right_w)
    c1 = col(pixel_down_w)
    warp_inv = torch.stack([c0, c1], dim=-1)
    det = c0[..., 0] * c1[..., 1] - c0[..., 1] * c1[..., 0]
    # Level = number of quarterings needed to bring det <= 3, capped.
    scaled = torch.stack([det * (0.25 ** lev) for lev in range(LEVELS)],
                         dim=-1)
    level = torch.clamp(torch.sum((scaled > 3.0).to(torch.int64), dim=-1),
                        max=LEVELS - 1)
    det_at = torch.gather(scaled, -1, level[..., None])[..., 0]
    good = (det_at <= 3.0) & (det_at >= 0.25)
    return WarpResult(warp_inv=warp_inv, level=level, good=good)


def inv2x2(m: Tensor) -> Tensor:
    """Batched 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    return torch.stack([torch.stack([d, -b], dim=-1),
                        torch.stack([-c, a], dim=-1)],
                       dim=-2) * inv_det[..., None, None]


def _patch_grid(patch_size: int, device) -> Tensor:
    """(P*P, 2) (x, y) offsets from the integer patch centre."""
    c = patch_size // 2
    r = torch.arange(patch_size, dtype=torch.float32, device=device) - c
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def make_warped_templates(kf_atlases: Tensor, kf_idx: Tensor,
                          src_center: Tensor, m2: Tensor, src_bounds: Tensor,
                          patch_size: int = PATCH_SIZE,
                          window: int = 28) -> tuple:
    """Warp templates for all points at once.

    kf_atlases (K, Ha, Wa); kf_idx (N,) source keyframe; src_center (N, 2)
    source centre in atlas coords; m2 (N, 2, 2) source pixels per template
    pixel; src_bounds (N, 4) (x0, y0, x1, y1) of the source level rect.
    Samples must stay inside the source level and inside the (window,
    window) neighbourhood gathered around the centre (the JAX package's
    ``in_win`` gate). Returns (templates (N, P, P), good (N,)).
    """
    N = src_center.shape[0]
    dev = src_center.device
    offsets = _patch_grid(patch_size, dev)                  # (Q, 2)
    pts = src_center[:, None, :] + offsets @ m2.transpose(-1, -2)

    K, Ha, Wa = kf_atlases.shape
    S = min(window, Ha, Wa)
    c = torch.round(src_center).to(torch.int64)
    ox = torch.clamp(c[:, 0] - S // 2, 0, Wa - S)
    oy_lvl = torch.clamp(c[:, 1] - S // 2, 0, Ha - S)
    oy = kf_idx.to(torch.int64) * Ha + oy_lvl
    win = gather_windows(kf_atlases.reshape(K * Ha, Wa), oy, ox,
                         S)                                 # (N, S, S)

    lx = pts[..., 0] - ox[:, None].to(torch.float32)
    ly = pts[..., 1] - oy_lvl[:, None].to(torch.float32)
    fx0 = torch.floor(lx)
    fy0 = torch.floor(ly)
    fx = lx - fx0
    fy = ly - fy0
    x0 = fx0.to(torch.int64)
    y0 = fy0.to(torch.int64)
    in_win = (x0 >= 0) & (y0 >= 0) & (x0 <= S - 2) & (y0 <= S - 2)
    x0c = torch.clamp(x0, 0, S - 2)
    y0c = torch.clamp(y0, 0, S - 2)
    flat = win.reshape(N, S * S)
    base = y0c * S + x0c

    def tap(off):
        return torch.gather(flat, 1, base + off)

    # Rows first, then columns: the order of the JAX package's two dots.
    left = (1 - fy) * tap(0) + fy * tap(S)
    right = (1 - fy) * tap(1) + fy * tap(S + 1)
    vals = (1 - fx) * left + fx * right

    inside = ((pts[..., 0] >= src_bounds[:, None, 0]) &
              (pts[..., 1] >= src_bounds[:, None, 1]) &
              (pts[..., 0] <= src_bounds[:, None, 2] - 1.0) &
              (pts[..., 1] <= src_bounds[:, None, 3] - 1.0))
    good = torch.all(inside & in_win, dim=-1)
    return vals.reshape(N, patch_size, patch_size), good


def make_warped_templates_flat(kf_atlases: Tensor, kf_idx: Tensor,
                               src_center: Tensor, m2: Tensor,
                               src_bounds: Tensor,
                               patch_size: int = PATCH_SIZE) -> tuple:
    """The templates of ``make_warped_templates`` by four flat-index taps a
    sample from the atlases (JAX's ``make_warped_templates_flat``, its
    reference formulation): no window, so no window gate; a sample whose
    corner leaves the atlas reads the clamped one. A bf16 atlas's taps
    are weighted in float32. Returns (templates (N, P, P) float32, good
    (N,))."""
    offsets = _patch_grid(patch_size, src_center.device)      # (Q, 2)
    pts = src_center[:, None, :] + torch.einsum("nij,pj->npi", m2, offsets)
    K, Ha, Wa = kf_atlases.shape
    flat = kf_atlases.reshape(-1)
    x, y = pts[..., 0], pts[..., 1]
    fx0, fy0 = torch.floor(x), torch.floor(y)
    fx, fy = x - fx0, y - fy0
    x0c = torch.clamp(fx0.to(torch.int64), 0, Wa - 2)
    y0c = torch.clamp(fy0.to(torch.int64), 0, Ha - 2)
    base = kf_idx.to(torch.int64)[:, None] * (Ha * Wa) + y0c * Wa + x0c
    vals = (flat[base] * (1 - fx) * (1 - fy) + flat[base + 1] * fx * (1 - fy)
            + flat[base + Wa] * (1 - fx) * fy
            + flat[base + Wa + 1] * fx * fy)
    inside = ((x >= src_bounds[:, None, 0]) & (y >= src_bounds[:, None, 1])
              & (x <= src_bounds[:, None, 2] - 1.0)
              & (y <= src_bounds[:, None, 3] - 1.0))
    return (vals.to(torch.float32).reshape(-1, patch_size, patch_size),
            torch.all(inside, dim=-1))


@dataclasses.dataclass
class SearchResult:
    pos: Tensor      # (N, 2) float atlas coords of the best candidate
    ssd: Tensor      # (N,) best score
    found: Tensor    # (N,) bool
    margin: Tensor   # (N,) second-best score minus best (diagnostic)


def _integral_window_sums(win: Tensor, patch_size: int) -> Tensor:
    """(N, D, D) -> (N, D-P+1, D-P+1) PxP block sums via integral images."""
    ii = torch.cumsum(torch.cumsum(win, dim=-1), dim=-2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    P = patch_size
    return (ii[:, P:, P:] - ii[:, P:, :-P] - ii[:, :-P, P:]
            + ii[:, :-P, :-P])


def ssd_search(atlas: Tensor, corner_mask: Tensor, templates: Tensor,
               centers: Tensor, radius: Tensor, bounds: Tensor, *,
               r_win: int, max_ssd: float, zero_mean: bool = True,
               patch_size: int = PATCH_SIZE, bf16_cross: bool = False):
    """Batched windowed ZMSSD search (ZMSSDAtPoint's formula), or with
    ``zero_mean`` False the plain SSD (the MiniPatch search of trail
    tracking). With ``bf16_cross`` the cross term reads the templates and
    windows rounded to bfloat16 and sums their products in float32 in the
    JAX package's order; the other terms read them in float32. A product
    of two bfloat16 values is exact in float32, and the JAX package's
    compiled programs keep it so (XLA drops the bfloat16 rounding of the
    product it writes, under its default ``xla_allow_excess_precision``);
    its op-by-op ``ssd_search(bf16_cross=True)`` rounds each product to
    bfloat16 and parts from both by up to ~1e3 in ZMSSD.

    atlas (Ha, Wa) f32 or bf16 (K2 gives f32 windows of either);
    corner_mask (Ha, Wa) bool; templates (N, P, P);
    centers (N, 2) predicted atlas positions; radius (N,) search radius in
    level pixels (at most ``r_win``; the tracker validates its config);
    bounds (N, 4) level rect per point. Returns (SearchResult, windows
    (N, D, D), window origins (N, 2) float (x, y)), the windows being
    reused by ``subpix_refine``.
    """
    N = templates.shape[0]
    P = patch_size
    ph = P // 2
    D = 2 * r_win + P                 # window side
    M = 2 * r_win + 1                 # candidate-map side
    Ha, Wa = atlas.shape
    dev = atlas.device

    base = torch.round(centers).to(torch.int64)
    origin_x = torch.clamp(base[:, 0] - r_win - ph, 0, Wa - D)
    origin_y = torch.clamp(base[:, 1] - r_win - ph, 0, Ha - D)
    win, cmask = gather_window_pair(atlas, corner_mask, origin_y, origin_x,
                                    D, ph, M)

    SSQ_t = torch.sum(templates * templates, dim=(-2, -1))
    SSQ_img = _integral_window_sums(win * win, P)
    t, w = templates, win
    if bf16_cross:
        t = t.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    cross = torch.zeros((N, M, M), dtype=torch.float32, device=dev)
    for dy in range(P):
        for dx in range(P):
            cross = cross + (t[:, dy, dx][:, None, None]
                             * w[:, dy: dy + M, dx: dx + M])
    if zero_mean:
        SA = torch.sum(templates, dim=(-2, -1))[:, None, None]
        S_img = _integral_window_sums(win, P)
        ssd = ((2.0 * SA * S_img - SA ** 2 - S_img * S_img) / float(P * P)
               + SSQ_img + SSQ_t[:, None, None] - 2.0 * cross)
    else:
        ssd = SSQ_img + SSQ_t[:, None, None] - 2.0 * cross

    g = torch.arange(M, device=dev)
    pos_x = origin_x[:, None, None] + g[None, None, :] + ph     # (N, 1, M)
    pos_y = origin_y[:, None, None] + g[None, :, None] + ph     # (N, M, 1)
    fpx = pos_x.to(torch.float32)
    fpy = pos_y.to(torch.float32)
    dx = fpx - centers[:, 0, None, None]
    dy = fpy - centers[:, 1, None, None]
    in_radius = dx * dx + dy * dy <= (radius ** 2)[:, None, None]
    b = ph + 1   # the patch plus a 1-px subpix border stays in the level
    in_level = ((fpx - b >= bounds[:, None, None, 0]) &
                (fpy - b >= bounds[:, None, None, 1]) &
                (fpx + b <= bounds[:, None, None, 2]) &
                (fpy + b <= bounds[:, None, None, 3]))
    ok = in_radius & in_level & cmask
    flat = torch.where(ok, ssd, BIG).reshape(N, M * M)
    best = torch.argmin(flat, dim=-1)      # the first minimum, as jnp
    best_ssd = torch.gather(flat, 1, best[:, None])[:, 0]
    second = torch.min(flat.scatter(1, best[:, None], BIG), dim=-1).values
    bx = origin_x + best % M + ph
    by = origin_y + best // M + ph
    result = SearchResult(
        pos=torch.stack([bx, by], dim=-1).to(torch.float32), ssd=best_ssd,
        found=best_ssd < max_ssd, margin=second - best_ssd)
    origin = torch.stack([origin_x, origin_y], -1).to(torch.float32)
    return result, win, origin


@dataclasses.dataclass
class SubPixResult:
    pos: Tensor        # (N, 2) refined atlas coords
    converged: Tensor  # (N,) bool
    last_step: Tensor  # (N,) squared step of each point's last update


MARGIN = 3      # subpixel excursion allowed in a gathered window (px)


def subpix_refine(atlas: Tensor, templates: Tensor, pos0: Tensor,
                  bounds: Tensor, *, max_its: int = 10,
                  conv_limit: float = 0.03, patch_size: int = PATCH_SIZE,
                  windows: Tensor | None = None,
                  win_origin: Tensor | None = None) -> SubPixResult:
    """Batched inverse-composition alignment (3 DoF: x, y, mean
    difference) of templates (N, P, P) against ``atlas`` from atlas
    positions ``pos0`` (N, 2). It reads ``windows`` (N, D, D) at
    ``win_origin`` (N, 2) (x, y) where the caller gathered them (the ZMSSD
    search windows, which contain the best candidate); otherwise it
    gathers one (P + 2*MARGIN + 1)^2 window per point around the rounded
    start (kernel K2). The loop is ``kernels/subpix.py``'s (kernel K6 on
    the card). All patch pixels share one bilinear fraction, as in the
    reference."""
    P = patch_size
    ph = P // 2
    if windows is None:
        Ha, Wa = atlas.shape
        D = P + 2 * MARGIN + 1
        c0 = torch.round(pos0).to(torch.int64)
        org_x = torch.clamp(c0[:, 0] - ph - MARGIN, 0, Wa - D)
        org_y = torch.clamp(c0[:, 1] - ph - MARGIN, 0, Ha - D)
        windows = gather_windows(atlas, org_y, org_x, D)
        win_origin = torch.stack([org_x, org_y], -1).to(torch.float32)
    pos, converged, last_step = ksubpix.subpix_refine(
        templates, pos0, bounds, windows, win_origin, max_its, conv_limit,
        patch_size)
    return SubPixResult(pos=pos, converged=converged, last_step=last_step)
