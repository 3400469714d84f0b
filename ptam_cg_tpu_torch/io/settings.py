"""settings.cfg-compatible configuration loader (port of
``ptam_cg_tpu.io.settings``, onto the port's own ``config.py``).

Parses the reference's GVars3 config syntax (ref: config/settings.cfg,
config/camera.cfg; GUI.LoadFile at src/main.cc:21) — ``Name = value``,
``Name = [ a b c ]`` vectors, quoted strings, ``//`` comments, and
``exec other.cfg`` includes — and maps the reference's tunable names onto
the typed EngineConfig dataclasses, so a reference user's config files
work unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Tuple

from ptam_cg_tpu_torch import config as cfglib


def parse_gvars(path: str, vars_out: Dict[str, object] | None = None
                ) -> Dict[str, object]:
    """Parse one cfg file (recursing into ``exec`` includes)."""
    out: Dict[str, object] = {} if vars_out is None else vars_out
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for raw in f:
            line = raw.split("//")[0].strip()
            if not line:
                continue
            m = re.match(r"^exec\s+(.+)$", line)
            if m:
                inc = m.group(1).strip().strip('"')
                inc_path = inc if os.path.isabs(inc) \
                    else os.path.normpath(os.path.join(base, inc))
                if os.path.exists(inc_path):
                    parse_gvars(inc_path, out)
                continue
            m = re.match(r"^([\w.]+)\s*=\s*(.+)$", line)
            if not m:
                continue
            name, val = m.group(1), m.group(2).strip()
            if val.startswith("["):
                nums = [float(x) for x in
                        re.findall(r"[-+0-9.eE]+", val)]
                out[name] = tuple(nums)
            elif val.startswith('"'):
                out[name] = val.strip('"')
            else:
                try:
                    fv = float(val)
                    out[name] = int(fv) if fv == int(fv) else fv
                except ValueError:
                    out[name] = val
    return out


#: gvar name -> (sub-config attr, field, converter)
_MAPPING = {
    "Camera.Parameters": ("camera", "params",
                          lambda v: tuple(float(x) for x in v)),
    "VideoSource.Resolution": ("camera", "image_size",
                               lambda v: (int(v[0]), int(v[1]))),
    "Tracker.MaxInitialTrails": ("tracker", "max_initial_trails", int),
    "Tracker.RotationEstimatorBlur": ("tracker", "rotation_estimator_blur",
                                      float),
    "Tracker.UseRotationEstimator": ("tracker", "use_rotation_estimator",
                                     lambda v: bool(int(v))),
    "Tracker.UseConstantVelocity": ("tracker", "use_constant_velocity",
                                    lambda v: bool(int(v))),
    "Tracker.CoarseMin": ("tracker", "coarse_min", int),
    "Tracker.CoarseMax": ("tracker", "coarse_max", int),
    "Tracker.CoarseRange": ("tracker", "coarse_range", float),
    "Tracker.CoarseSubPixIts": ("tracker", "coarse_subpix_its", int),
    "Tracker.DisableCoarse": ("tracker", "disable_coarse",
                              lambda v: bool(int(v))),
    "Tracker.MEstimator": ("tracker", "mestimator", str.lower),
    "Tracker.CoarseMinVelocity": ("tracker", "coarse_min_velocity", float),
    "Tracker.MaxPatchesPerFrame": ("tracker", "max_patches_per_frame",
                                   int),
    "Tracker.TrackingQualityGood": ("tracker", "tracking_quality_good",
                                    float),
    "Tracker.TrackingQualityLost": ("tracker", "tracking_quality_lost",
                                    float),
    "MapMaker.CandidateMinShiTomasiScore": (
        "mapmaker", "candidate_min_shi_tomasi_score", float),
    "MapMaker.WiggleScale": ("mapmaker", "wiggle_scale", float),
    "MapMaker.MaxKFDistWiggleMult": ("mapmaker", "max_kf_dist_wiggle_mult",
                                     float),
    "MapMaker.PlaneAlignerRansacs": ("mapmaker", "plane_aligner_ransacs",
                                     int),
    "Bundle.MEstimator": ("bundle", "mestimator", str.lower),
    "Bundle.MaxIterations": ("bundle", "max_iterations", int),
    "Bundle.UpdateSquaredConvergenceLimit": (
        "bundle", "update_squared_convergence_limit", float),
    "Bundle.MinTukeySigma": ("bundle", "min_sigma", float),
    "Reloc2.MaxScore": ("reloc", "max_score", float),
}


def load_engine_config(path: str) -> Tuple[cfglib.EngineConfig, Dict]:
    """Load a settings.cfg into an EngineConfig. Returns (config, the raw
    parsed vars — including names we don't map, e.g. VideoSource.DataSet).
    """
    gv = parse_gvars(path)
    cfg = cfglib.EngineConfig()
    updates: Dict[str, Dict] = {}
    for name, value in gv.items():
        if name not in _MAPPING:
            continue
        sub, field, conv = _MAPPING[name]
        updates.setdefault(sub, {})[field] = conv(value)
    for sub, kw in updates.items():
        cfg = dataclasses.replace(
            cfg, **{sub: dataclasses.replace(getattr(cfg, sub), **kw)})
    return cfg, gv
