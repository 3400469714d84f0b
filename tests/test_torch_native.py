"""The port's C++ frame pump (tests/test_native.py's cases, mirrored): the
source is the JAX package's byte for byte, the library is built under
``ptam_cg_tpu_torch/_build/``, the frames equal the Python reader's, and a
failed build raises."""

from pathlib import Path

import numpy as np
import pytest

from ptam_cg_tpu_torch import native
from ptam_cg_tpu_torch.io import tum

ROOT = Path(__file__).resolve().parent.parent


def make_ds(tmp_path, n=6):
    frames = [np.random.default_rng(i).uniform(0, 255, (24, 32))
              .astype(np.float32) for i in range(n)]
    tum.write_synthetic_dataset(str(tmp_path), frames)
    return frames


def test_source_is_the_jax_package_s():
    assert ((ROOT / "ptam_cg_tpu_torch" / "native" / "framepump.cpp")
            .read_bytes()
            == (ROOT / "ptam_cg_tpu" / "native" / "framepump.cpp")
            .read_bytes())


def test_library_builds_into_the_port_s_build_dir():
    native.load_library()
    so = native.library_path()
    assert so.is_file()
    assert so.parent == ROOT / "ptam_cg_tpu_torch" / "_build"


def test_pump_matches_python_reader(tmp_path):
    make_ds(tmp_path)
    ds = tum.TumDataset(str(tmp_path))
    with native.NativeFramePump(str(tmp_path), prefetch=2) as pump:
        assert len(pump) == len(ds) == 6
        for i in range(6):
            ts, fr = pump.next_frame()
            want_ts, want = ds.next_frame()
            assert fr.dtype == np.float32 and fr.shape == (24, 32)
            np.testing.assert_array_equal(fr, want)
            assert ts == pytest.approx(want_ts)


def test_pump_wraps_around(tmp_path):
    frames = make_ds(tmp_path, 3)
    with native.NativeFramePump(str(tmp_path), prefetch=2) as pump:
        for i in range(7):
            _, fr = pump.next_frame()
            np.testing.assert_array_equal(fr, frames[i % 3])


def test_pump_non_looping_stops(tmp_path):
    make_ds(tmp_path, 2)
    with native.NativeFramePump(str(tmp_path), prefetch=2,
                                loop=False) as pump:
        pump.next_frame()
        pump.next_frame()
        with pytest.raises(StopIteration):
            pump.next_frame()


def test_pump_uint8_npy_and_pgm_match_python_reader(tmp_path):
    (tmp_path / "rgb").mkdir()
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    np.save(tmp_path / "rgb" / "u8.npy", arr)
    with open(tmp_path / "rgb" / "f.pgm", "wb") as f:
        f.write(b"P5\n# comment\n4 3\n255\n" + arr.tobytes())
    with open(tmp_path / "rgb" / "g.pgm", "wb") as f:   # maxval 220
        f.write(b"P5 4 3 220\n" + arr.tobytes())
    (tmp_path / "rgb.txt").write_text(
        "0.5 rgb/u8.npy\n1.0 rgb/f.pgm\n1.5 rgb/g.pgm\n")
    ds = tum.TumDataset(str(tmp_path))
    with native.NativeFramePump(str(tmp_path)) as pump:
        for i in range(3):
            _, fr = pump.next_frame()
            np.testing.assert_array_equal(fr, ds.frame(i))
    np.testing.assert_array_equal(ds.frame(0), arr.astype(np.float32))
    np.testing.assert_array_equal(
        ds.frame(2), arr.astype(np.float32)
        * (np.float32(255.0) / np.float32(220)))


def test_missing_dataset_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.NativeFramePump(str(tmp_path / "nonexistent"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet switch to the Python reader: a build that fails raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-x", "no-such-language"))
    make_ds(tmp_path / "ds", 1)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeFramePump(str(tmp_path / "ds"))
