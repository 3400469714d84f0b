"""Compare two tracking results, two keyframe integrations, or two runs
of trail tracking.

Two runs on the same inputs can differ where float noise decides: the
sums of the ZMSSD search and the subpixel solve are taken in another
order on another device or framework. Such a difference is explained when
the port's own diagnostics show the decision was that close: the best and
second-best ZMSSD candidates nearly tie, the best ZMSSD sits at the
acceptance limit, the subpixel step sat at its convergence limit, or (for
an epipolar candidate) its distance to the nearest measurement sat at the
thinning radius. Anything else is a real difference.
"""

from __future__ import annotations

import numpy as np

from ptam_cg_tpu_torch.models.map_state import SRC_REFIND
from ptam_cg_tpu_torch.models.tracker import MAX_SSD

#: A ZMSSD gap this small (absolute, plus relative to the score) is float
#: noise of the window sums.
SSD_TIE_ABS = 2.0
SSD_TIE_REL = 1e-4
#: A squared subpixel step within this factor of the limit is "at" it.
STEP_BAND = (0.5, 2.0)
CONV_LIMIT_SQ = 0.03 * 0.03


def _why(ssd: float, margin: float, step: float):
    tol = SSD_TIE_ABS + SSD_TIE_REL * abs(ssd)
    if margin <= tol:
        return "ZMSSD near-tie"
    if abs(ssd - MAX_SSD) <= tol:
        return "ZMSSD at the acceptance limit"
    lo, hi = STEP_BAND
    if lo * CONV_LIMIT_SQ <= step <= hi * CONV_LIMIT_SQ:
        return "subpixel step at the convergence limit"
    return None


def found_set_differences(ref_point, ref_valid, ref_pos, result,
                          pos_tol: float = 0.05):
    """Differences between a reference found set and a port TrackResult.

    ``ref_point`` (T,), ``ref_valid`` (T,), ``ref_pos`` (T, 2) are numpy
    arrays of the reference (JAX or another device's port run). Returns a
    list of dicts, one per point found by only one side or found by both
    more than ``pos_tol`` level-0 px apart, each with the port's
    diagnostics and ``reason`` (None when nothing explains it).
    """
    pt = result.meas_point.cpu().numpy()
    valid = result.meas_valid.cpu().numpy()
    pos = result.meas_pos.cpu().numpy()
    ssd = result.meas_ssd.cpu().numpy()
    margin = result.meas_ssd_margin.cpu().numpy()
    step = result.meas_subpix_step.cpu().numpy()
    ref = {int(p): np.asarray(q) for p, q, v in
           zip(ref_point, ref_pos, ref_valid) if v}
    mine = {int(p): i for i, (p, v) in enumerate(zip(pt, valid)) if v}
    # Slot of each point in the port's working set, for points it missed.
    slot = {}
    for i, p in enumerate(pt):
        slot.setdefault(int(p), i)
    out = []
    for p in sorted(set(ref) | set(mine)):
        if p in ref and p in mine:
            d = float(np.max(np.abs(ref[p] - pos[mine[p]])))
            if d <= pos_tol:
                continue
            kind, i = f"position differs by {d:.3g} px", mine[p]
        elif p in mine:
            kind, i = "found by the port only", mine[p]
        else:
            kind, i = "found by the reference only", slot.get(p)
        diag = (dict(ssd=float(ssd[i]), margin=float(margin[i]),
                     step=float(step[i])) if i is not None else {})
        reason = _why(**diag) if diag else None
        out.append(dict(point=p, kind=kind, reason=reason, **diag))
    return out


#: A candidate this close (px at its level) to the thinning radius.
THIN_BAND = 1e-3


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def integration_differences(ref: dict, port: dict, before_valid, slot: int,
                            diag: dict, thin_radius: float = 10.0,
                            pos_tol: float = 1e-3):
    """Differences between a reference keyframe integration and the
    port's, both run on the same map, features and measurements.

    ``ref`` and ``port`` map the MapState field names ``point_valid``,
    ``point_src_level``, ``point_center``, ``point_pos``, ``meas_valid``,
    ``meas_pos`` and ``meas_source`` to arrays of the integrated maps;
    ``before_valid`` is ``point_valid`` before integration; ``diag`` is
    the port's ``integrate_keyframe_program`` diagnostics. Re-found
    points are matched by index. New points are matched by (level,
    candidate position), since one candidate more or less shifts the map
    slots of all later ones; their positions and measurements are held to
    ``pos_tol``. Returns (differences, counts): each difference a dict
    with ``reason`` None when nothing explains it; counts of the
    reference's re-found points and new points per level.
    """
    ref = {k: _np(v) for k, v in ref.items()}
    port = {k: _np(v) for k, v in port.items()}
    before = _np(before_valid)
    out = []

    # Re-found in the new keyframe.
    rd = {k: _np(v) for k, v in diag["refind"].items()}

    def refound(s):
        return s["meas_valid"][slot] & (s["meas_source"][slot] == SRC_REFIND)

    r_ref, r_port = refound(ref), refound(port)
    for p in np.nonzero(r_ref | r_port)[0]:
        if r_ref[p] and r_port[p]:
            d = float(np.max(np.abs(ref["meas_pos"][slot, p]
                                    - port["meas_pos"][slot, p])))
            if d <= pos_tol:
                continue
            kind = f"re-find position differs by {d:.3g} px"
        else:
            kind = ("re-found by the port only" if r_port[p]
                    else "re-found by the reference only")
        diag_p = dict(ssd=float(rd["ssd"][p]), margin=float(rd["margin"][p]),
                      step=float(rd["step"][p]))
        out.append(dict(point=int(p), kind=kind, reason=_why(**diag_p),
                        **diag_p))

    # New points, keyed by (level, candidate x, y).
    def new_points(s):
        idx = np.nonzero(s["point_valid"] & ~before)[0]
        return {(int(s["point_src_level"][i]),
                 *map(int, s["point_center"][i])): i for i in idx}

    n_ref, n_port = new_points(ref), new_points(port)
    counts = dict(refound=int(r_ref.sum()),
                  added={lev: sum(k[0] == lev for k in n_ref)
                         for lev in sorted({int(k) for k in diag
                                            if k != "refind"})})
    for key in sorted(set(n_ref) | set(n_port)):
        lev = key[0]
        if key in n_ref and key in n_port:
            i, j = n_ref[key], n_port[key]
            d_pt = float(np.max(np.abs(ref["point_pos"][i]
                                       - port["point_pos"][j])))
            both = ref["meas_valid"][:, i] | port["meas_valid"][:, j]
            same_kfs = np.array_equal(ref["meas_valid"][:, i],
                                      port["meas_valid"][:, j])
            d_meas = float(np.max(np.abs(ref["meas_pos"][both, i]
                                         - port["meas_pos"][both, j])))
            if same_kfs and d_pt <= pos_tol and d_meas <= pos_tol:
                continue
            kind = (f"new point differs: position {d_pt:.3g}, measurements "
                    f"{d_meas:.3g} px, same keyframes {same_kfs}")
        else:
            kind = ("added by the port only" if key in n_port
                    else "added by the reference only")
        cd = {k: _np(v) for k, v in diag[lev].items()}
        c = int(np.nonzero((cd["cand_xy"] == np.array(key[1:])).all(-1))[0][0])
        diag_c = dict(ssd=float(cd["ssd"][c]), margin=float(cd["margin"][c]),
                      step=float(cd["step"][c]))
        reason = _why(**diag_c)
        thin = float(np.sqrt(cd["thin_d2"][c]))
        if reason is None and abs(thin - thin_radius) <= THIN_BAND:
            reason = "candidate at the thinning radius"
        out.append(dict(level=lev, candidate=key[1:], kind=kind,
                        reason=reason, thin_dist=thin, **diag_c))
    return out, counts


def trail_differences(a, b, diag_a: dict, diag_b: dict,
                      max_ssd: float) -> list:
    """Trails on which two runs of ``trail_advance`` from the same trails
    differ (good in one only, or good in both at other positions), each
    with ``reason``: a near-tie of either run's forward or backward
    search, an SSD at ``max_ssd``, or a return distance at the married
    match's limit of 2 px^2 (within float noise); None otherwise."""
    def np_(x):
        return x.detach().cpu().numpy()

    va, vb = np_(a.valid), np_(b.valid)
    pa, pb = np_(a.cur_pos), np_(b.cur_pos)
    diags = [{k: np_(v) for k, v in d.items()} for d in (diag_a, diag_b)]
    out = []
    for i in np.nonzero((va != vb) | (va & vb & np.any(pa != pb, axis=-1)))[0]:
        reason = None
        for d in diags:
            for side in ("fwd", "bwd"):
                ssd = float(d[f"{side}_ssd"][i])
                tol = SSD_TIE_ABS + SSD_TIE_REL * abs(ssd)
                if float(d[f"{side}_margin"][i]) <= tol:
                    reason = reason or f"{side} SSD near-tie"
                elif abs(ssd - max_ssd) <= tol:
                    reason = reason or f"{side} SSD at the acceptance limit"
            if abs(float(d["ret"][i]) - 2.0) <= 1e-4:
                reason = reason or "return distance at the limit"
        out.append(dict(trail=int(i), valid=(bool(va[i]), bool(vb[i])),
                        pos=(pa[i].tolist(), pb[i].tolist()), reason=reason))
    return out
