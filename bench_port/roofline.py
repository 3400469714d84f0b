"""The least time a tracked frame's counted work needs on the card.

The work is counted from the shapes of the calls a tracked frame makes
(recorded once, when the tracking program first runs: every replay repeats
the same shapes), so it reads the same whatever kernel carries it out. The
counts follow ``chip_smoke.py``'s (its constants are copied here), cut
down to what the shapes alone fix, so each is a lower bound:

- FAST scoring of the pyramid (``ops.fast.fast_atlas``): each level's
  pixels read once (float32) and the corner mask written (and, with
  scores, the score atlas); 11 operations a pixel at least 3 px inside a
  level (c+t, c-t, 8 compass compares, the test). The arc test's work on
  pixels with two compass pixels beyond the threshold depends on the image
  and is not counted.
- Window gathers (``gather_windows``, ``gather_window_pair``): the windows
  written and the origins read. The source bytes under the windows depend
  on where the windows fall; only one window's are counted.
- The Gauss-Newton pose loop (``kernels.pose_gn.pose_gn``): one iteration's
  41 operations for every point (projection and error) and the points'
  coordinates and flags read. The iterations run and the points found
  depend on the data.
- The SBI ESM (``kernels.sbi_esm.esm``): the warp of every pixel, 25
  operations, each of its iterations, and the three images read.

Not counted yet (no count exists): the ZMSSD search, the sub-pixel
refinement and ``se3_from_se2``.

Peaks: one H100 SXM, 3.35 TB/s of HBM and 67 TFLOP/s float32 outside the
tensor cores (NVIDIA's data sheet, at 700 W).
"""

from __future__ import annotations

import threading

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
FAST_OPS = 11
GN_OPS_ALL = 41
ESM_OPS_ALL = 25
LEVELS = 4


def _bound(ops: float, nbytes: float) -> float:
    return max(ops / F32_OPS_S, nbytes / HBM_BYTES_S)


def fast_bound(atlas_shape, itemsize: int, scores: bool) -> float:
    Ha, W = atlas_shape
    H = Ha * 2 // 3
    nbytes = ops = 0
    for k in range(LEVELS):
        h, w = H >> k, W >> k
        nbytes += h * w * (itemsize + 1 + (4 if scores else 0))
        ops += FAST_OPS * max(h - 6, 0) * max(w - 6, 0)
    return _bound(ops, nbytes)


def gather_bound(n: int, windows, out_itemsizes, src_itemsizes,
                 origin_itemsize: int) -> float:
    nbytes = 2 * n * origin_itemsize
    for D, out_i, src_i in zip(windows, out_itemsizes, src_itemsizes):
        nbytes += n * D * D * out_i + D * D * src_i
    return _bound(0, nbytes)


def gn_bound(n: int) -> float:
    return _bound(GN_OPS_ALL * n, n * (3 * 4 + 1 + 1 + 4))


def esm_bound(h: int, w: int, iterations: int) -> float:
    return _bound(ESM_OPS_ALL * h * w * iterations, h * w * 4 * 4)


class Recorder:
    """Wraps the port's entry points of the counted stages and keeps the
    bound of each call made inside the last ``track_frame_from_image``
    (``frame``: [(stage, seconds)])."""

    def __init__(self):
        self.frame = []
        self._local = threading.local()

    def _add(self, stage: str, seconds: float) -> None:
        calls = getattr(self._local, "calls", None)
        if calls is not None:
            calls.append((stage, seconds))

    def install(self, patches) -> None:
        """Wrap the entry points through ``patches`` (a ``cell.Patches``)."""
        from ptam_cg_tpu_torch.kernels import pose_gn, sbi_esm
        from ptam_cg_tpu_torch.models import tracker
        from ptam_cg_tpu_torch.ops import fast, patch

        def wrap(owner, attr, bound):
            def make(fn):
                def counted(*a, **kw):
                    self._add(attr, bound(*a, **kw))
                    return fn(*a, **kw)
                return counted
            patches.wrap(owner, attr, make)

        wrap(fast, "fast_atlas", lambda atlas, thresholds, scores=False:
             fast_bound(atlas.shape, atlas.element_size(), scores))
        wrap(patch, "gather_windows", lambda atlas, oy, ox, D: gather_bound(
            oy.numel(), (D,), (4,), (atlas.element_size(),),
            oy.element_size()))
        wrap(patch, "gather_window_pair",
             lambda atlas, mask, oy, ox, D, offset, M: gather_bound(
                 oy.numel(), (D, M), (4, mask.element_size()),
                 (atlas.element_size(), mask.element_size()),
                 oy.element_size()))
        wrap(pose_gn, "pose_gn", lambda pose, cam, size, pts, *a, **kw:
             gn_bound(pts.shape[0]))
        wrap(sbi_esm, "esm", lambda moving, target, jac, n_iterations=10:
             esm_bound(moving.shape[0], moving.shape[1], n_iterations))

        def make(track):
            def recorded(*a, **kw):
                self._local.calls = []
                try:
                    return track(*a, **kw)
                finally:
                    self.frame, self._local.calls = self._local.calls, None
            return recorded
        patches.wrap(tracker, "track_frame_from_image", make)

    def frame_bound_s(self) -> float:
        return sum(s for _, s in self.frame)
