"""Map and BA checkpoints: save and resume (port of
``ptam_cg_tpu.io.checkpoint``, the same npz schema).

The reference can only dump a map (SaveMap writes point positions and
keyframe poses as text, src/MapMaker.cc:1229-1257). Here the whole
``MapState`` round-trips through one compressed ``.npz`` whose keys are
the JAX package's: ``map.<field>`` for each map field (the port's
``MapState`` has JAX's field names, dtypes and shapes), ``trk.*`` for the
tracker state and ``prob.*`` / ``lm.*`` for a BA state, so a checkpoint
moves between the two packages either way. The port writes no
``trk.key`` (a JAX PRNG key; the JAX loader does without one) and does
not save the port's ``LMState.layout``, which ``load_ba_state`` builds
again from the problem.

A bfloat16 ``kf_atlas`` (``FrontendConfig.atlas_bf16``) is written as the
JAX package writes its own: ``np.asarray`` of a JAX bfloat16 array is an
ml_dtypes array, which ``np.savez`` stores as raw two-byte ``|V2``
elements. The loaders read ``|V2`` (and ml_dtypes' bfloat16) back as
``torch.bfloat16`` through a 16-bit integer view, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ptam_cg_tpu_torch.models import bundle
from ptam_cg_tpu_torch.models import tracker as trklib
from ptam_cg_tpu_torch.models.map_state import MapState
from ptam_cg_tpu_torch.utils.se3 import SE3

_LM_SCALARS = ("lam", "lam_factor", "converged", "accepted", "iters",
               "last_error", "failed")


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as the raw ``|V2`` elements JAX's
    checkpoints hold."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def is_bf16(a: np.ndarray) -> bool:
    """Whether a numpy array holds bfloat16: ml_dtypes' (an array of a JAX
    bfloat16 tensor) or the raw ``|V2`` elements ``np.load`` gives back."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def tensor_of(a: np.ndarray, device) -> torch.Tensor:
    """A writable copy of a numpy array as a tensor of the same dtype on
    ``device``; bfloat16 (``is_bf16``) as ``torch.bfloat16``."""
    if is_bf16(a):
        return torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def save_map(path: str, m: MapState,
             tracker_state: Optional[trklib.TrackerState] = None,
             meta: Optional[dict] = None) -> None:
    """Write ``m`` (and the tracker state) to ``path``; ``meta`` goes to
    ``path + ".meta.json"``."""
    arrays = {f"map.{f.name}": _np(getattr(m, f.name))
              for f in dataclasses.fields(m)}
    if tracker_state is not None:
        st = tracker_state
        arrays["trk.pose_R"] = _np(st.pose.R)
        arrays["trk.pose_t"] = _np(st.pose.t)
        arrays["trk.velocity"] = _np(st.velocity)
        arrays["trk.scalars"] = np.array([
            float(st.msd_vel), float(st.lost_frames), float(st.quality),
            float(st.just_recovered), float(st.depth_mean),
            float(st.depth_sigma)])
    _savez(path, arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_map(path: str, device="cuda"):
    """Returns (MapState, TrackerState or None) on ``device``. The tracker
    state's generator is seeded with 0 (a JAX file's ``trk.key`` has no
    torch counterpart)."""
    data = np.load(path)

    def t(name):
        return tensor_of(data[name], device)

    m = MapState(**{f.name: t(f"map.{f.name}")
                    for f in dataclasses.fields(MapState)})
    trk = None
    if "trk.pose_R" in data:
        s = data["trk.scalars"]
        trk = trklib.init_tracker_state(SE3(t("trk.pose_R"), t("trk.pose_t")))
        dev = trk.pose.R.device
        trk = dataclasses.replace(
            trk, velocity=t("trk.velocity"),
            msd_vel=torch.tensor(s[0], dtype=torch.float32, device=dev),
            lost_frames=torch.tensor(int(s[1]), dtype=torch.int32,
                                     device=dev),
            quality=torch.tensor(int(s[2]), dtype=torch.int32, device=dev),
            just_recovered=torch.tensor(bool(s[3]), device=dev),
            depth_mean=torch.tensor(s[4], dtype=torch.float32, device=dev),
            depth_sigma=torch.tensor(s[5], dtype=torch.float32, device=dev))
    return m, trk


def save_ba_state(path: str, state: bundle.LMState) -> None:
    """Checkpoint a BA ``LMState`` mid-run (its problem and its LM
    scalars), so a run can restart from disk."""
    arrays = {f"prob.{f.name}": _np(getattr(state.problem, f.name))
              for f in dataclasses.fields(state.problem)}
    arrays.update({f"lm.{k}": _np(getattr(state, k)) for k in _LM_SCALARS})
    _savez(path, arrays)


def load_ba_state(path: str, device="cuda") -> bundle.LMState:
    """Inverse of ``save_ba_state``, on ``device``; the measurement layout
    is built from the problem (one host read)."""
    data = np.load(path)

    def t(name):
        return tensor_of(data[name], device)

    prob = bundle.BundleProblem(**{
        f.name: t(f"prob.{f.name}")
        for f in dataclasses.fields(bundle.BundleProblem)})
    state = bundle.init_lm(prob)
    scalars = {k: t(f"lm.{k}") for k in _LM_SCALARS if f"lm.{k}" in data}
    scalars.setdefault("failed", torch.zeros((), dtype=torch.bool,
                                             device=prob.pt_pos.device))
    return dataclasses.replace(state, **scalars)


def export_map_text(path_prefix: str, m: MapState) -> None:
    """The reference's text dump (SaveMap, src/MapMaker.cc:1229-1257):
    ``<prefix>map.dump`` with point positions and source levels, and a
    ``.info`` pose file per keyframe under ``<prefix>keyframes/``."""
    valid, pos, lvl = _np(m.point_valid), _np(m.point_pos), \
        _np(m.point_src_level)
    with open(path_prefix + "map.dump", "w") as f:
        for i in np.nonzero(valid)[0]:
            f.write(f"{pos[i, 0]} {pos[i, 1]} {pos[i, 2]}  {lvl[i]}\n")
    kf_valid, R, t = _np(m.kf_valid), _np(m.kf_R), _np(m.kf_t)
    os.makedirs(path_prefix + "keyframes", exist_ok=True)
    for k in np.nonzero(kf_valid)[0]:
        with open(os.path.join(path_prefix + "keyframes", f"{k}.info"),
                  "w") as f:
            for row in range(3):
                f.write(" ".join(str(x) for x in R[k, row])
                        + f" {t[k, row]}\n")
