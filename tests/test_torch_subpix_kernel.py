"""K6 (the sub-pixel refinement of patch matches): the plain version
against ``ops/patch.py``, the wrapper's refusals, the loop's settle rule,
and the kernel against its plain version on the card.

Inputs are made from numpy seeds on the synthetic texture: each point's
8x8 template is a bilinear sample of the texture at a true position
(plus noise), its start the nearest candidate position of a window whose
top-left lies at an integer origin, as the ZMSSD search hands them over.
Shapes (N, D, iterations): the tracker's coarse (128, 40, 8) and fine
(1024, 30, 8) calls, the MapMaker's re-find (256, 16, 8), and the
gathered 15x15 windows of the epipolar search and the stereo init
(512, 15, 10).

- On the CPU: ``kernels/subpix.subpix_refine_plain`` is what
  ``ops/patch.subpix_refine`` returns, on the caller's windows and on the
  windows it gathers; ``validate`` refuses what the kernel cannot take; a
  point whose converging step leaves its bounds fails when an iteration
  remains and converges when that step was the last. (The JAX parity of
  the loop is ``tests/test_torch_ops.py``'s.)
- On the CPU besides: PyTorch's CPU products of the loop's small matrices
  (H = J^T J, J^T d, Hinv u) add their terms one after the other from
  zero, in sample order, with each product rounded: the order the kernel
  follows.
- On the card (``cuda`` marker; skipped without a GPU): the kernel against
  the plain loop on the CPU at each shape, bit for bit, the gathered one
  through ``ops/patch.subpix_refine`` (K2, then K6); and against the plain
  loop on the card, whose cuBLAS products sum in another order. Bars there:
  positions within 1e-4 px; the last step's length (its square root)
  within 2e-4 px plus 1e-5 of the length: a step is the difference of two
  positions, each held to 1e-4 px, and a long one rounds by its length (a
  short one loses its relative digits); the converged sets equal but where
  ``utils/parity.py`` calls the last step at the convergence limit. Two
  launches bit-identical, one launch a call, a CUDA-graph replay equal to
  the eager call bit for bit, and the settle rule. A GPU machine need not
  have JAX: run them with ``python -m pytest
  tests/test_torch_subpix_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from ptam_cg_tpu_torch.io import synth as tsynth
from ptam_cg_tpu_torch.kernels import subpix as ksubpix
from ptam_cg_tpu_torch.ops import patch as tpatchops
from ptam_cg_tpu_torch.ops.gather import gather_windows_plain
from ptam_cg_tpu_torch.utils import parity

torch.set_num_threads(2)

P = 8
CONV_LIMIT = 0.03
POS_TOL = 1e-4
LEN_RTOL = 1e-5
#: (N, D, iterations, seed): the tracker's coarse and fine calls, the
#: re-find's windows (r_win = 4), the gathered 15x15 windows.
SHAPES = {"coarse": (128, 40, 8, 1), "fine": (1024, 30, 8, 2),
          "refind": (256, 16, 8, 3), "gathered": (512, 15, 10, 4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bilinear(im, x, y):
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx * (1 - fy)
            + im[y0 + 1, x0] * (1 - fx) * fy + im[y0 + 1, x0 + 1] * fx * fy)


def make_inputs(N, D, seed):
    """(atlas (H, W), templates (N, 8, 8), pos0 (N, 2), bounds (N, 4),
    windows (N, D, D), origin (N, 2)) as float32 CPU tensors. True
    positions lie up to 0.7 px off the start (a tenth up to 2 px); the
    first eighth of the points have a level rect whose right edge cuts
    their window, so some fail."""
    rng = np.random.default_rng(seed)
    im = tsynth.make_texture(np.random.default_rng(1), device="cpu").numpy()
    H, W = im.shape
    ox = rng.integers(2, W - D - 2, N)
    oy = rng.integers(2, H - D - 2, N)
    # A candidate position: the centre of a PxP block inside the window,
    # one pixel in from its edges (the search's in-level margin).
    gx = rng.integers(1, D - P, N)
    gy = rng.integers(1, D - P, N)
    pos0 = np.stack([ox + gx + P // 2, oy + gy + P // 2], -1).astype(float)
    off = rng.uniform(-0.7, 0.7, (N, 2))
    far = rng.random(N) < 0.1
    off[far] = rng.uniform(-2.0, 2.0, (int(far.sum()), 2))
    true = pos0 + off
    ys, xs = np.mgrid[0:P, 0:P]
    tx = true[:, 0, None, None] - P // 2 + xs
    ty = true[:, 1, None, None] - P // 2 + ys
    tmpl = _bilinear(im, np.clip(tx, 0, W - 2), np.clip(ty, 0, H - 2))
    tmpl = tmpl + rng.normal(0, 2.0, tmpl.shape)
    bounds = np.tile(np.array([[0.0, 0.0, W, H]]), (N, 1))
    cut = N // 8
    bounds[:cut, 2] = pos0[:cut, 0] + P // 2 + 1 + rng.uniform(0, 1.5, cut)
    rows = oy[:, None] + np.arange(D)
    cols = ox[:, None] + np.arange(D)
    win = im[rows[:, :, None], cols[:, None, :]]
    origin = np.stack([ox, oy], -1)
    f32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
           for a in (im, tmpl, pos0, bounds, win, origin)]
    return tuple(f32)


def settle_case(last_iteration):
    """A point of ``make_inputs`` whose converging step (iteration ``j``)
    leaves its level rect, with the rect's edge put between that step's
    position and every earlier one. Returns (inputs of that point alone,
    with the rect changed, and max_its): ``j + 1`` iterations when the
    converging step is the last, else ``j + 2``."""
    _, tmpl, pos0, bounds, win, origin = make_inputs(256, 30, 7)
    its = 8
    path, conv_at = [pos0], []
    for k in range(1, its + 1):
        pos, conv, _ = ksubpix.subpix_refine_plain(tmpl, pos0, bounds, win,
                                                   origin, k, CONV_LIMIT)
        path.append(pos)
        conv_at.append(conv)
    for n in range(tmpl.shape[0]):
        j = next((k for k in range(its - 1) if conv_at[k][n]), None)
        if j is None:
            continue
        before = torch.stack([p[n, 0] for p in path[:j + 1]])
        after = path[j + 1][n, 0]
        if after > before.max() + 1e-3:
            b = bounds[n:n + 1].clone()
            b[0, 2] = float(before.max() + 0.5 * (after - before.max())) + 5
            one = (tmpl[n:n + 1], pos0[n:n + 1], b, win[n:n + 1],
                   origin[n:n + 1])
            return one, j + 1 if last_iteration else j + 2
    raise AssertionError("no point converges with a step in +x")


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_is_what_ops_patch_returns(shape):
    N, D, its, seed = SHAPES[shape]
    atlas, tmpl, pos0, bounds, win, origin = make_inputs(N, D, seed)
    if shape == "gathered":
        # ops/patch gathers its own windows around the rounded start.
        sp = tpatchops.subpix_refine(atlas, tmpl, pos0, bounds, max_its=its)
        c0 = torch.round(pos0).to(torch.int64)
        ph, m = P // 2, tpatchops.MARGIN
        org_x = torch.clamp(c0[:, 0] - ph - m, 0, atlas.shape[1] - D)
        org_y = torch.clamp(c0[:, 1] - ph - m, 0, atlas.shape[0] - D)
        win = gather_windows_plain(atlas, org_y, org_x, D)
        origin = torch.stack([org_x, org_y], -1).to(torch.float32)
    else:
        sp = tpatchops.subpix_refine(atlas, tmpl, pos0, bounds, max_its=its,
                                     windows=win, win_origin=origin)
    pos, conv, step = ksubpix.subpix_refine_plain(tmpl, pos0, bounds, win,
                                                  origin, its, CONV_LIMIT)
    assert torch.equal(sp.pos, pos) and torch.equal(sp.converged, conv)
    assert torch.equal(sp.last_step, step)
    # The inputs exercise both outcomes.
    assert N // 4 < int(conv.sum()) < N


@pytest.mark.parametrize("last_iteration", [False, True])
def test_a_converging_step_out_of_bounds_fails_unless_it_was_the_last(
        last_iteration):
    one, its = settle_case(last_iteration)
    pos, conv, step = ksubpix.subpix_refine_plain(*one, its, CONV_LIMIT)
    assert bool(conv[0]) == last_iteration
    assert 0 < float(step[0]) < CONV_LIMIT ** 2


def _sequential(a, b):
    """(B, M, K) @ (B, K, L) in float32, each product rounded and added
    to the sum of the ones before it, from zero, in the order of K."""
    out = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for k in range(a.shape[2]):
        out = (out + (a[:, :, k, None] * b[:, None, k, :]).astype(np.float32)
               ).astype(np.float32)
    return out


@pytest.mark.parametrize("product", ["H", "J^T d", "Hinv u"])
def test_the_cpu_product_adds_in_sample_order(product):
    """The order K6 sums in is the order of the plain loop on the CPU."""
    N, D, its, seed = SHAPES["fine"]
    _, tmpl, *_ = make_inputs(N, D, seed)
    gx = 0.5 * (tmpl[:, 1:-1, 2:] - tmpl[:, 1:-1, :-2])
    gy = 0.5 * (tmpl[:, 2:, 1:-1] - tmpl[:, :-2, 1:-1])
    J = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(N, -1, 3)
    rng = np.random.default_rng(seed)
    if product == "H":
        a, b = J.transpose(1, 2), J
    elif product == "J^T d":
        a = torch.from_numpy(rng.normal(0, 20, (N, 1, J.shape[1]))
                             .astype(np.float32))
        b = J
    else:
        a = ksubpix.inv3x3(J.transpose(1, 2) @ J
                           + 1e-9 * torch.eye(3))
        b = torch.from_numpy(rng.normal(0, 1e3, (N, 3, 1)).astype(np.float32))
    got = (a @ b).numpy()
    want = _sequential(a.numpy(), b.numpy())
    assert np.array_equal(got, want)


BAD = {
    "patch size": dict(patch_size=6),
    "narrow window": dict(windows=torch.zeros(4, P + 1, P + 1)),
    "wide window": dict(windows=torch.zeros(4, ksubpix.MAX_D + 1,
                                            ksubpix.MAX_D + 1)),
    "iterations": dict(max_its=ksubpix.MAX_ITS + 1),
    "negative iterations": dict(max_its=-1),
    "no point": dict(templates=torch.zeros(0, P, P), pos0=torch.zeros(0, 2),
                     bounds=torch.zeros(0, 4), windows=torch.zeros(0, 30, 30),
                     win_origin=torch.zeros(0, 2)),
    "templates dtype": dict(templates=torch.zeros(4, P, P,
                                                  dtype=torch.float64)),
    "bounds dtype": dict(bounds=torch.zeros(4, 4, dtype=torch.int64)),
    "windows dtype": dict(windows=torch.zeros(4, 30, 30,
                                              dtype=torch.bfloat16)),
    "strided pos0": dict(pos0=torch.zeros(2, 4).T),
    "strided windows": dict(windows=torch.zeros(4, 30, 30).transpose(1, 2)),
    "shape": dict(win_origin=torch.zeros(3, 2)),
    "non-square window": dict(windows=torch.zeros(4, 30, 31)),
    "device": dict(bounds=torch.zeros(4, 4, device="meta")),
}


@pytest.mark.parametrize("what", list(BAD))
def test_validate_refuses_what_the_kernel_cannot_take(what):
    args = dict(templates=torch.zeros(4, P, P), pos0=torch.zeros(4, 2),
                bounds=torch.zeros(4, 4), windows=torch.zeros(4, 30, 30),
                win_origin=torch.zeros(4, 2), max_its=8)
    ksubpix.validate(**args)
    ksubpix.validate(**dict(args, windows=torch.zeros(4, P + 2, P + 2),
                            max_its=ksubpix.MAX_ITS))
    with pytest.raises(ValueError):
        ksubpix.validate(**dict(args, **BAD[what]))


def test_subpix_refine_needs_the_cpu_or_the_card():
    """Not on the CPU and not on the card: no plain fallback."""
    meta = [torch.zeros(s, device="meta")
            for s in ((4, P, P), (4, 2), (4, 4), (4, 30, 30), (4, 2))]
    with pytest.raises(ValueError, match="CUDA"):
        ksubpix.subpix_refine(*meta, 8, CONV_LIMIT)


# ----------------------------------------------------------------- card


def assert_close_to_plain(got, ref):
    (p, c, s), (pr, cr, sr) = got, ref
    assert float((p - pr).abs().max()) <= POS_TOL
    assert float(((s.sqrt() - sr.sqrt()).abs()
                  - LEN_RTOL * sr.sqrt()).max()) <= 2 * POS_TOL
    lo, hi = parity.STEP_BAND
    differ = (c != cr).cpu()
    at_limit = ((sr >= lo * CONV_LIMIT ** 2) & (sr <= hi * CONV_LIMIT ** 2)
                ).cpu()
    assert not bool((differ & ~at_limit).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_subpix_kernel_matches_plain(cuda, shape, monkeypatch):
    N, D, its, seed = SHAPES[shape]
    atlas, *rest = [x.to(cuda) for x in make_inputs(N, D, seed)]
    tmpl, pos0, bounds, win, origin = rest
    before = ksubpix.launches
    if shape == "gathered":
        runs = [tpatchops.subpix_refine(atlas, tmpl, pos0, bounds,
                                        max_its=its) for _ in range(2)]
        monkeypatch.setattr(ksubpix, "subpix_refine",
                            ksubpix.subpix_refine_plain)
        sp = tpatchops.subpix_refine(atlas, tmpl, pos0, bounds, max_its=its)
        runs = [(r.pos, r.converged, r.last_step) for r in runs]
        ref = (sp.pos, sp.converged, sp.last_step)
    else:
        runs = [ksubpix.subpix_refine(tmpl, pos0, bounds, win, origin, its,
                                      CONV_LIMIT) for _ in range(2)]
        ref = ksubpix.subpix_refine_plain(tmpl, pos0, bounds, win, origin,
                                          its, CONV_LIMIT)
    torch.cuda.synchronize()
    assert ksubpix.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert_close_to_plain(runs[0], ref)
    assert N // 4 < int(runs[0][1].sum()) < N
    # The plain loop on the CPU, bit for bit.
    cpu = [x.cpu() for x in (atlas, tmpl, pos0, bounds, win, origin)]
    if shape == "gathered":
        sp = tpatchops.subpix_refine(*cpu[:4], max_its=its)
        ref_cpu = (sp.pos, sp.converged, sp.last_step)
    else:
        ref_cpu = ksubpix.subpix_refine_plain(*cpu[1:], its, CONV_LIMIT)
    for a, b in zip(runs[0], ref_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("last_iteration", [False, True])
def test_subpix_kernel_settles_as_the_plain_loop(cuda, last_iteration):
    one, its = settle_case(last_iteration)
    one = [x.to(cuda) for x in one]
    pos, conv, step = ksubpix.subpix_refine(*one, its, CONV_LIMIT)
    ref = ksubpix.subpix_refine_plain(*one, its, CONV_LIMIT)
    assert bool(conv[0]) == last_iteration == bool(ref[1][0])
    assert_close_to_plain((pos, conv, step), ref)
    ref_cpu = ksubpix.subpix_refine_plain(*[x.cpu() for x in one], its,
                                          CONV_LIMIT)
    for a, b in zip((pos, conv, step), ref_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_subpix_kernel_graph_replay_is_the_eager_call(cuda):
    N, D, its, seed = SHAPES["fine"]
    _, tmpl, pos0, bounds, win, origin = [x.to(cuda)
                                          for x in make_inputs(N, D, seed)]
    args = (tmpl, pos0, bounds, win, origin, its, CONV_LIMIT)
    eager = ksubpix.subpix_refine(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ksubpix.subpix_refine(*args)                 # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ksubpix.subpix_refine(*args)
    for x in captured:
        x.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
