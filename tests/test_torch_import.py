"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points put tensors on the card unless asked for the CPU."""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ptam_cg_tpu_torch"

_PROBE = """
import pkgutil, sys
before = set(sys.modules)
import ptam_cg_tpu_torch
for mod in pkgutil.walk_packages(ptam_cg_tpu_torch.__path__,
                                 "ptam_cg_tpu_torch."):
    __import__(mod.name)
added = set(sys.modules) - before
print(len([m for m in added if m.startswith("ptam_cg_tpu_torch")]))
print(",".join(sorted(m for m in added
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))))
print(",".join(sorted(m for m in sys.modules
                      if m == "ptam_cg_tpu" or m.startswith("ptam_cg_tpu."))))
"""


def test_importing_every_module_adds_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    n_modules = len(list(PKG.rglob("*.py")))
    assert int(out[0]) == n_modules > 10
    assert out[1] == "", out[1]


def test_importing_every_module_adds_no_jax_package_module():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    assert out[2] == "", out[2]


def test_no_source_file_imports_jax():
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if any(line.strip().startswith(("import jax", "from jax"))
                        for line in p.read_text().splitlines())]
    assert offenders == []


#: An import of the JAX package (``ptam_cg_tpu`` or a module of it, not
#: ``ptam_cg_tpu_torch``), in any of Python's import forms.
_JAX_PACKAGE = re.compile(
    r"^\s*(from\s+ptam_cg_tpu(\.\S+)?\s+import\b"
    r"|import\s+(\S+\s*,\s*)*ptam_cg_tpu(\.\S+)?(\s|,|$))")


#: Modules whose scan the tests below must include (the port's slices).
SCANNED = ("models/tracker.py", "models/keyframe.py", "models/mapmaker.py",
           "models/bundle.py", "models/homography.py",
           "models/initializer.py", "models/relocalizer.py",
           "models/engine.py", "utils/geometry.py", "utils/mest.py",
           "utils/evaluate.py", "io/synth.py", "io/from_jax.py")


def test_source_scan_covers_every_slice():
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(SCANNED) <= files, set(SCANNED) - files


def test_no_source_line_imports_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}:{i}" for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if _JAX_PACKAGE.match(line)]
    assert offenders == []
    assert _JAX_PACKAGE.match("from ptam_cg_tpu.config import LEVELS")
    assert _JAX_PACKAGE.match("    import ptam_cg_tpu.ops.fast as f")
    assert not _JAX_PACKAGE.match("from ptam_cg_tpu_torch.config import X")


def _entry_points():
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.io import from_jax, synth
    from ptam_cg_tpu_torch.models import engine, map_state, tracker
    return [atan.make_camera, map_state.empty_map, synth.make_texture,
            tracker.init_tracker_state, engine.SLAMEngine, engine.Draws,
            synth.orbit_trajectory, synth.SyntheticSequence,
            from_jax.tensor, from_jax.se3_from_numpy,
            from_jax.camera_from_numpy, from_jax.sbi_from_numpy,
            from_jax.track_features_from_numpy,
            from_jax.frame_features_from_numpy,
            from_jax.map_state_from_numpy, from_jax.tracker_state_from_numpy,
            from_jax.bundle_problem_from_numpy, from_jax.lm_state_from_numpy,
            from_jax.trail_state_from_numpy, from_jax.matches_from_numpy,
            from_jax.homography_result_from_numpy,
            synth.ba_problem, synth.ba_map]


def test_entry_points_default_to_the_card():
    for fn in _entry_points():
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__


def test_empty_map_and_make_camera_ask_for_cuda():
    """Without a device they make CUDA tensors, so on a machine with no
    card they raise instead of falling back to the CPU (the engine, its
    draws and the tracker state too)."""
    from ptam_cg_tpu_torch.camera import atan
    from ptam_cg_tpu_torch.models import engine, map_state, tracker
    calls = [lambda: map_state.empty_map((64, 48), max_points=8, max_kfs=2),
             lambda: atan.make_camera((1.0, 1.4, 0.5, 0.5, 0.25), (64, 48)),
             lambda: tracker.init_tracker_state().pose.R,
             lambda: engine.Draws().track(4)[0],
             lambda: engine.SLAMEngine(image_size=(64, 48), max_points=8,
                                       max_kfs=2).map]
    for call in calls:
        if torch.cuda.is_available():
            leaf = call()
            t = getattr(leaf, "point_pos", None)
            if t is None:
                t = getattr(leaf, "params", leaf)
            assert t.is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    cam = atan.make_camera((1.0, 1.4, 0.5, 0.5, 0.25), (64, 48), "cpu")
    assert cam.focal.device.type == "cpu"
