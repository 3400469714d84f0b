"""The roofline counts are chip_smoke.py's, cut to what the shapes fix:
equal to its counts where those do not depend on the data, never above."""

import importlib.util

import pytest
import torch

from bench_port import roofline
ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    path = ROOT / "chip_smoke.py"
    if not path.is_file():
        pytest.skip("chip_smoke.py, whose counts these copy, is gone")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_are_chip_smokes(smoke):
    assert roofline.HBM_BYTES_S == smoke.HBM_BYTES_S
    assert roofline.F32_OPS_S == smoke.F32_OPS_S
    assert roofline.GN_OPS_ALL == smoke.GN_OPS_ALL
    assert roofline.ESM_OPS_ALL == smoke.ESM_OPS_ALL


@pytest.mark.parametrize("size", [(640, 480), (752, 480)])
def test_fast_operations_are_chip_smokes_inner_pixels(smoke, size):
    W, H = size
    g = torch.Generator().manual_seed(3)
    levels = [torch.rand((H >> k, W >> k), generator=g) * 255
              for k in range(4)]
    n_inner, n_polar = smoke.fast_work(levels, (10, 15, 15, 10), torch)
    ops = roofline.FAST_OPS * sum(max(h - 6, 0) * max(w - 6, 0)
                                  for h, w in (l.shape for l in levels))
    assert ops == roofline.FAST_OPS * n_inner
    # The bound counts no arc test (data-dependent): below chip_smoke's.
    assert roofline.fast_bound((H * 3 // 2, W), 4, True) <= max(
        (roofline.FAST_OPS * n_inner + 81 * n_polar) / smoke.F32_OPS_S,
        sum(l.numel() for l in levels) * 9 / smoke.HBM_BYTES_S)


@pytest.mark.parametrize("shape", [(30, 40), (30, 47)])
def test_esm_counts_every_pixel_each_iteration(smoke, shape):
    h, w = shape
    # chip_smoke.esm_ops at a mask with no pixel inside: 25 a pixel an
    # iteration, which is all the shape fixes.
    ops = 10 * smoke.ESM_OPS_ALL * h * w
    assert roofline.esm_bound(h, w, 10) == max(
        ops / smoke.F32_OPS_S, h * w * 16 / smoke.HBM_BYTES_S)


@pytest.mark.parametrize("n", [128, 1152])
def test_gn_counts_one_iteration_of_every_point(smoke, n):
    assert roofline.gn_bound(n) == max(smoke.GN_OPS_ALL * n / smoke.F32_OPS_S,
                                       n * 18 / smoke.HBM_BYTES_S)
