"""The plain reference that decides ``correct``, in float64 NumPy.

It knows the scene from the benchmark's own renderer (``scene.py``): each
frame's true pose, the boxes and the plane, and the bytes of every frame.
It reads the engine's outputs only to judge them: each frame's pose, and
the map's keyframes (pose and stored pyramid) and points (``judge``).

The numbers that decide ``correct`` need no alignment: a monocular map has
its own frame and scale, and drifts slowly along a sweep, which moves any
comparison after one similarity; the motion between two poses, its
rotation and the direction of its translation, does not depend on either.
The keyframes' stored pyramids are compared with the pyramid of the frame
each was made from (found by its level-0 image, which is that frame's
bytes), grey level for grey level.
"""

from __future__ import annotations

import hashlib

import numpy as np

LEVELS = 4


def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle (rad) of Ra Rb^T: |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which
    keeps its precision at small angles, where the trace's arccos loses
    it."""
    f = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return 2.0 * np.arcsin(np.clip(f, 0.0, 1.0))


def to_world(R: np.ndarray, t: np.ndarray):
    """World -> camera (R, t) -> camera -> world rotation and centre."""
    R_wc = np.swapaxes(R, -1, -2)
    return R_wc, -np.einsum("...ij,...j->...i", R_wc, t)


def similarity(R_est, c_est, R_true, c_true):
    """(s, Ra, ta) with true ~ s Ra est + ta, rotations Ra R_est ~ R_true:
    Ra from the rotations (the polar factor of their sum), then s and ta by
    least squares on the centres."""
    M = np.einsum("nij,nkj->ik", R_true, R_est)
    U, _, Vt = np.linalg.svd(M)
    Ra = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    y = c_est @ Ra.T
    yc, cc = y - y.mean(0), c_true - c_true.mean(0)
    s = float((yc * cc).sum() / max((yc * yc).sum(), 1e-300))
    return s, Ra, c_true.mean(0) - s * y.mean(0)


def pose_errors(sim, R_est, t_est, R_true, t_true, unit):
    """(rotation error rad, centre error / unit), per pose."""
    s, Ra, ta = sim
    Rw_e, c_e = to_world(R_est, t_est)
    Rw_t, c_t = to_world(R_true, t_true)
    rot = rotation_angle(Rw_t, Ra @ Rw_e)
    pos = np.linalg.norm(s * c_e @ Ra.T + ta - c_t, axis=-1) / unit
    return rot, pos


def pyramid(im: np.ndarray):
    """The 4 levels of an image, each the 2x2 means of the one above."""
    out = [im.astype(np.float64)]
    for _ in range(LEVELS - 1):
        a = out[-1]
        h, w = a.shape[0] // 2, a.shape[1] // 2
        out.append(a[:2 * h, :2 * w].reshape(h, 2, w, 2).mean(axis=(1, 3)))
    return out


def atlas_levels(atlas: np.ndarray, H: int, W: int):
    """The levels of a (1.5 H, W) atlas (ops/levels.py's layout)."""
    offs = ((0, 0), (H, 0), (H, W // 2), (H, W // 2 + W // 4))
    return [atlas[r: r + (H >> k), c: c + (W >> k)]
            for k, (r, c) in enumerate(offs)]


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def match_keyframes(atlases, frames: np.ndarray):
    """For each keyframe atlas, (index of its frame, pyramid difference):
    the frame whose bytes its level 0 holds, or the nearest one."""
    n, H, W = frames.shape
    by_digest = {}
    for i in range(n):
        by_digest.setdefault(_digest(frames[i]), i)
    out = []
    for atlas in atlases:
        lev = atlas_levels(np.asarray(atlas, dtype=np.float64), H, W)
        l0 = lev[0]
        i = None
        if np.all(l0 == np.round(l0)) and l0.min() >= 0 and l0.max() <= 255:
            i = by_digest.get(_digest(l0.astype(np.uint8)))
        if i is None:
            sub = (slice(None, None, 8), slice(None, None, 8))
            i = int(np.argmin([np.abs(frames[j][sub] - l0[sub]).mean()
                               for j in range(n)]))
        ref = pyramid(frames[i])
        out.append((i, max(float(np.abs(a - b).max())
                           for a, b in zip(lev, ref))))
    return out


def surface_distance(p: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Each point's distance to the nearest surface of the scene: the z=0
    plane, or a box [cx +- half, cy +- half, z in [-height, 0]]."""
    d = np.abs(p[:, 2])
    for cx, cy, half, h in boxes:
        c = np.array([cx, cy, -h / 2.0])
        e = np.array([half, half, h / 2.0])
        q = np.abs(p - c) - e
        sdf = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
               + np.minimum(q.max(-1), 0.0))
        d = np.minimum(d, np.abs(sdf))
    return d


def relative(R: np.ndarray, t: np.ndarray, a, b):
    """The motion from pose a to pose b (world -> camera each): (R_b R_a^T,
    t_b - R_b R_a^T t_a). A change of the world's frame and scale leaves
    the rotation unchanged and scales the translation, so neither needs an
    alignment."""
    Rr = R[b] @ np.swapaxes(R[a], -1, -2)
    return Rr, t[b] - np.einsum("nij,nj->ni", Rr, t[a])


def direction_angle(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    un = u / np.linalg.norm(u, axis=-1, keepdims=True)
    vn = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return 2.0 * np.arcsin(np.clip(np.linalg.norm(un - vn, axis=-1) / 2.0,
                                   0.0, 1.0))


#: Frames apart over which the direction of travel is compared, and the
#: least true travel (share of the median over all such pairs) a pair needs:
#: at the sweep's ends the camera turns back and travels little.
DIR_STEP = 5
DIR_MIN_TRAVEL = 0.5


def spans_of(window: np.ndarray, step: int):
    """(a, b): the frames ``step`` apart with every frame from a to b in
    ``window`` (none straddles a frame left out)."""
    w = np.flatnonzero(window)
    a, b = w[:-step], w[step:]
    whole = b - a == step
    return a[whole], b[whole]


def judge(seq, frame_idx, R_est, t_est, tracked, window, kf_R, kf_t,
          kf_atlas, points, reloc=None) -> dict:
    """The numbers. ``frame_idx`` (N,): each handed-over frame's index in
    the sequence, with its estimated pose ``R_est`` (N, 3, 3), ``t_est``
    (N, 3); ``tracked`` (N,) marks the frames the similarity may use,
    ``window`` (N,) the frames judged; ``kf_*``: the map's valid
    keyframes; ``points`` (P, 3) its valid points. ``reloc``, where the
    mix covers the lens: ``pairs``, for each event that recovered, (the
    last GOOD frame judged before the cover, the recovered frame), and the
    count of ``unrecovered`` events.

    Scale-free, with no alignment: ``rel_rot_max``, the largest error of
    the rotation between consecutive frames of the window; ``rel_dir_max``,
    the largest angle between the estimated and the true direction of
    travel over ``DIR_STEP`` frames (both over judged frames only, and no
    pair or span straddles one left out); ``kf_rel_rot_max``, the same as
    ``rel_rot_max`` over every pair of keyframes. ``kf_pyramid_max`` as the
    module says. With ``reloc``: ``reloc_rel_rot_max`` and
    ``reloc_rel_dir_max``, the same as ``rel_rot_max`` and ``rel_dir_max``
    over the pairs of the events (each that recovered; a direction only
    where the true travel is ``DIR_MIN_TRAVEL`` of the median over
    ``DIR_STEP`` frames or more), and ``unrecovered``. A number with
    nothing to compare is left out. After the similarity (readings that a
    map's slow drift moves): ``pose_rot_max``, ``pose_pos_max``,
    ``kf_pos_max``, ``point_dist_p90``."""
    u = np.array([seq.index(int(k)) for k in frame_idx])
    R_true, t_true = seq.R[u], seq.t[u]
    unit = float(np.linalg.norm(seq.path.centers, axis=-1).mean())
    out = {}
    a, b = spans_of(window, 1)
    if len(a):
        Re, te = relative(R_est, t_est, a, b)
        Rt, _ = relative(R_true, t_true, a, b)
        out["rel_rot_max"] = float(rotation_angle(Re, Rt).max())
    a, b = spans_of(window, DIR_STEP)
    _, te = relative(R_est, t_est, a, b)
    _, tt = relative(R_true, t_true, a, b)
    travel = np.linalg.norm(tt, axis=-1)
    min_travel = DIR_MIN_TRAVEL * np.median(travel) if len(a) else 0.0
    far = travel >= min_travel
    if far.any():
        out["rel_dir_max"] = float(direction_angle(te[far], tt[far]).max())
    if reloc is not None:
        out.update(_reloc(R_est, t_est, R_true, t_true, reloc, min_travel))
    matches = match_keyframes(kf_atlas, seq.frames)
    ki = np.array([i for i, _ in matches])
    i, j = np.triu_indices(len(ki), 1)
    Rk, _ = relative(kf_R, kf_t, i, j)
    Rkt, _ = relative(seq.R[ki], seq.t[ki], i, j)
    out.update(kf_rel_rot_max=float(rotation_angle(Rk, Rkt).max(initial=0.0)),
               kf_pyramid_max=max(d for _, d in matches))
    if not np.any(tracked):
        return dict(out, pose_rot_max=np.inf, pose_pos_max=np.inf,
                    kf_pos_max=np.inf, point_dist_p90=np.inf)
    sim = similarity(*to_world(R_est[tracked], t_est[tracked]),
                     *to_world(R_true[tracked], t_true[tracked]))
    rot, pos = pose_errors(sim, R_est[window], t_est[window],
                           R_true[window], t_true[window], unit)
    _, k_pos = pose_errors(sim, kf_R, kf_t, seq.R[ki], seq.t[ki], unit)
    s, Ra, ta = sim
    dist = surface_distance(s * points @ Ra.T + ta, seq.boxes) / unit
    return dict(out, pose_rot_max=float(rot.max()),
                pose_pos_max=float(pos.max()), kf_pos_max=float(k_pos.max()),
                point_dist_p90=float(np.percentile(dist, 90)))


def _reloc(R_est, t_est, R_true, t_true, reloc: dict, min_travel: float):
    """The relocalizer's numbers (``judge``)."""
    out = dict(unrecovered=float(reloc["unrecovered"]))
    if not reloc["pairs"]:
        return out
    a, b = (np.array(x) for x in zip(*reloc["pairs"]))
    Re, te = relative(R_est, t_est, a, b)
    Rt, tt = relative(R_true, t_true, a, b)
    out["reloc_rel_rot_max"] = float(rotation_angle(Re, Rt).max())
    far = np.linalg.norm(tt, axis=-1) >= min_travel
    if far.any():
        out["reloc_rel_dir_max"] = float(
            direction_angle(te[far], tt[far]).max())
    return out
