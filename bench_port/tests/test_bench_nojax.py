"""No run loads JAX or the JAX package: top-level module names are compared
whole (``ptam_cg_tpu_torch`` begins with ``ptam_cg_tpu``)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    assert forbidden_modules({"ptam_cg_tpu_torch": 1,
                              "ptam_cg_tpu_torch.models.engine": 1,
                              "ptam_cg_tpu_tools": 1, "jaxtyping": 1,
                              "numpy": 1}) == []
    assert forbidden_modules({"ptam_cg_tpu.models.engine": 1}) == [
        "ptam_cg_tpu"]
    assert forbidden_modules({"jax._src.core": 1, "jaxlib": 1,
                              "flax.linen": 1}) == ["flax", "jax", "jaxlib"]


def test_what_a_run_imports_holds_no_jax():
    code = (
        "import json, sys\n"
        "sys.argv = ['run.py']\n"
        "import bench_port.run as run\n"
        "from bench_port import cell, control, reference, roofline, scene\n"
        "from bench_port import spec, trace, traffic\n"
        "from bench_port.spec import Spec\n"
        "s = Spec()\n"
        "for m in s.doc['end_to_end'] + s.doc['per_layer']:\n"
        "    s.reader(m['name'])\n"
        "import ptam_cg_tpu_torch.models.engine, ptam_cg_tpu_torch.io.synth\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


REPORT = """
import json, sys, types
sys.path.insert(0, sys.argv[1])
from bench_port import run
from bench_port.spec import Spec
spec = Spec(sys.argv[2], sys.argv[3])
cell = spec.doc["workloads"][0]["name"]
limits = spec.limits(cell)
outcome = types.SimpleNamespace(
    checks={k: 0.0 for k in limits}, infos=[], counted=[], lost=[], notes=[],
    ctx={"setup_s": 1.0, "window_s": 1.0, "frames": 1, "trace": None})
args = types.SimpleNamespace(workload=cell, trace=0)
sys.exit(run.report(spec, args, outcome, {}))
"""


@pytest.mark.parametrize("planted", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, planted):
    """The check runs once every metric's reader is loaded, just before the
    result is printed: a reader that imports ``jax`` (a stub here) makes
    the run exit 3 with no result line."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    here = tmp_path / "bench_port"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "bench_port" / d, here / d)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    if planted:
        (here / "metrics" / "setup_s.py").write_text(
            "import jax  # noqa: F401\n\n\n"
            "def read(ctx):\n    return ctx['setup_s']\n")
    out = subprocess.run(
        [sys.executable, "-c", REPORT, str(tmp_path / "stub"), str(tmp_path),
         str(here)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    lines = out.stdout.strip().splitlines()
    if planted:
        assert out.returncode == 3, out.stderr[-2000:]
        assert not any(ln.startswith("{") for ln in lines), out.stdout
        assert "['jax']" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(lines[-1])
        assert res["correct"] and res["metrics"]["setup_s"]["value"] == 1.0
