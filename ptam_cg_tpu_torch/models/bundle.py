"""Bundle adjustment: Levenberg-Marquardt with a Schur complement (port of
``ptam_cg_tpu.models.bundle``).

The problem is a fixed-capacity masked measurement table, as in the JAX
package. One LM step (``lm_step``) projects every measurement, weighs it
with the robust M-estimator, accumulates the normal-equation blocks U
(6x6 a camera), V (3x3 a point) and W (6x3 a measured (camera, point)
pair), forms the reduced camera system S = U* - W V*^-1 W^T as two float32
matrix products, solves it by Cholesky, back-substitutes the points, and
retries with a larger lambda until the robust error falls, the update
converges or the iteration budget runs out.

The accumulation is repeatable bit for bit on the card: nothing adds
floats with atomics. U and its right-hand side are one one-hot matrix
product. V and W are scattered, never added, into dense buffers in which
every measurement has a slot of its own, and summed there by a fixed-order
reduction: V over the measurements of a point, W over the (rare) repeats
of a (camera, point) pair. The slots come from ``MeasLayout``, built once
a problem (the measurement table does not change during BA) with one host
read: the most measurements any point has and any pair has.

JAX runs a chunk of LM steps, and each step's lambda retries, as device
``while_loop``s. ``lm_chunk`` is that chunk as ``cfg.max_iterations``
try slots (a chunk from ``iters`` makes at most ``max_iterations -
iters`` tries): a slot runs while the chunk runs, starts a step (robust
sigma and the accumulators) when the last try did not ask for a retry,
and tries one lambda, whose accept, retry and flags are ``torch.where``s.
Each slot's parts are ``graphs.if_block``s, but for its camera solve:
cuSOLVER's ``cholesky_solve`` cannot sit in a CUDA graph's conditional
body (so no WHILE node can hold a try), and two triangular solves, which
can, round otherwise on the card. Eagerly the host reads one flag vector
a try (whether the next slot runs, whether it retries, the flags), and a
step with n retries reads n + 1 times; as a CUDA graph (``ChunkProgram``)
the slots are IF nodes on flags on the card and a chunk reads its flags
once. ``lm_step_flags`` is one step with a host loop of tries, bit for
bit the same.

Matrix products must be float32: ``lm_step`` raises on a card that allows
TF32 (the JAX package pins float32 for the same reason: reduced-precision
products corrupt the normal equations).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import BundleConfig
from ptam_cg_tpu_torch.models import graphs
from ptam_cg_tpu_torch.utils import mest
from ptam_cg_tpu_torch.utils import se3 as se3lib

Tensor = torch.Tensor


@dataclasses.dataclass
class BundleProblem:
    """Static-shape BA problem (capacities carried by shapes)."""

    cam_R: Tensor               # (C, 3, 3) world -> camera
    cam_t: Tensor               # (C, 3)
    cam_fixed: Tensor           # (C,) bool: pose held constant
    cam_valid: Tensor           # (C,) bool
    pt_pos: Tensor              # (P, 3)
    pt_valid: Tensor            # (P,) bool
    meas_cam: Tensor            # (M,) int32
    meas_pt: Tensor             # (M,) int32
    meas_pos: Tensor            # (M, 2) found level-0 pixel position
    meas_sqrt_inv_noise: Tensor  # (M,) 1 / 2^level
    meas_valid: Tensor          # (M,) bool: an active measurement
    meas_bad: Tensor            # (M,) bool: a pruned outlier


@dataclasses.dataclass
class MeasLayout:
    """Each measurement's slot in the dense accumulators. A measurement
    that is invalid or indexes out of range goes to the dump camera ``C``
    and dump point ``P`` (rows the accumulators drop), at rank 0."""

    cam: Tensor       # (M,) int64 camera, C for the dump
    pt: Tensor        # (M,) int64 point, P for the dump
    pt_rank: Tensor   # (M,) int64 rank among its point's measurements
    pair_rank: Tensor  # (M,) int64 rank among its (camera, point) pair's
    n_pt: int         # the most measurements a point has, to a power of 2
    n_pair: int       # the most measurements a pair has, to a power of 2


@dataclasses.dataclass
class LMState:
    problem: BundleProblem
    layout: MeasLayout
    lam: Tensor           # () LM lambda
    lam_factor: Tensor    # ()
    converged: Tensor     # () bool
    accepted: Tensor      # () int32: accepted steps
    iters: Tensor         # () int32: inner iterations consumed
    last_error: Tensor    # ()
    failed: Tensor        # () bool: numerical failure; the map is likely
    #                       corrupt (Bundle::Compute returning -1)


def _run_rank(key: Tensor) -> Tensor:
    """Rank of each entry among the earlier entries with the same key."""
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    rank_sorted = (torch.arange(key.shape[0], device=key.device)
                   - torch.searchsorted(sk, sk))
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def measurement_layout(prob: BundleProblem) -> MeasLayout:
    """The accumulator slots of ``prob``'s measurements; reads the two
    largest ranks on the host (the one host read of a BA problem) and
    rounds each count up to a power of two."""
    C, P = prob.cam_R.shape[0], prob.pt_pos.shape[0]
    mc, mp = prob.meas_cam.long(), prob.meas_pt.long()
    live = prob.meas_valid & (mc >= 0) & (mc < C) & (mp >= 0) & (mp < P)
    cam = torch.where(live, mc, C)
    pt = torch.where(live, mp, P)
    pt_rank = torch.where(live, _run_rank(pt), 0)
    pair_rank = torch.where(live, _run_rank(cam * (P + 1) + pt), 0)
    n_pt, n_pair = (torch.stack([pt_rank.max(), pair_rank.max()]) + 1).tolist()
    # Powers of two: the slots past the largest rank stay zero, and a BA
    # chunk's CUDA graph, which bakes the counts in, serves more problems.
    return MeasLayout(cam=cam, pt=pt, pt_rank=pt_rank, pair_rank=pair_rank,
                      n_pt=pow2ceil(n_pt), n_pair=pow2ceil(n_pair))


def init_lm(problem: BundleProblem, cfg: BundleConfig = BundleConfig(),
            layout: MeasLayout | None = None) -> LMState:
    """The LM start state, scalars on the problem's device. ``layout`` is
    built from ``problem`` when not given."""
    dev = problem.pt_pos.device

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=dev)

    return LMState(problem=problem,
                   layout=(measurement_layout(problem) if layout is None
                           else layout),
                   lam=scalar(cfg.lambda_initial, torch.float32),
                   lam_factor=scalar(cfg.lambda_factor_initial, torch.float32),
                   converged=scalar(False, torch.bool),
                   accepted=scalar(0, torch.int32),
                   iters=scalar(0, torch.int32),
                   last_error=scalar(float("inf"), torch.float32),
                   failed=scalar(False, torch.bool))


def _project_meas(cam_R, cam_t, pt_pos, prob: BundleProblem, cam: atan.Camera):
    """Project every measurement (ProjectAndFindSquaredError). Returns
    (p_cam, z1, eps, err_sq, bad_proj). Gathers clamp out-of-range
    indices, as JAX's do."""
    C, P = cam_R.shape[0], pt_pos.shape[0]
    mc = prob.meas_cam.long().clamp(0, C - 1)
    R = cam_R[mc]                                        # (M, 3, 3)
    p = pt_pos[prob.meas_pt.long().clamp(0, P - 1)]
    p_cam = (R @ p[..., None])[..., 0] + cam_t[mc]
    z = p_cam[..., 2]
    bad_proj = z <= 1e-6
    safe_z = torch.where(bad_proj, 1.0, z)
    z1 = p_cam[..., :2] / safe_z[..., None]
    pix = atan.project(z1, cam)
    eps = prob.meas_sqrt_inv_noise[:, None] * (prob.meas_pos - pix)
    err_sq = torch.sum(eps * eps, dim=-1)
    # Non-finite residuals (a NaN point or measurement) count as failed
    # projections, so they are pruned instead of poisoning the sums.
    bad_proj = bad_proj | ~torch.isfinite(err_sq)
    err_sq = torch.where(bad_proj, 0.0, err_sq)
    return p_cam, z1, eps, err_sq, bad_proj


def _jacobians(p_cam, z1, cam_R_meas, cam: atan.Camera, scale):
    """(A (M, 2, 6), B (M, 2, 3)) with each measurement's scale (robust
    square-root weight times inverse noise) folded in."""
    derivs = atan.project_derivs(z1, cam) * scale[:, None, None]
    z = p_cam[..., 2]
    inv_z = (1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z))[..., None, None]
    gen = se3lib.motion_jacobian(p_cam)                   # (M, 6, 3)
    plane_a = (gen[..., :2] - p_cam[..., None, :2] * gen[..., 2:] * inv_z) * inv_z
    A = torch.einsum("mij,mnj->min", derivs, plane_a)     # (M, 2, 6)
    # B: motion of p_cam per unit world-point motion = columns of R.
    cols = cam_R_meas.transpose(-1, -2)                   # (M, 3(col), 3)
    plane_b = (cols[..., :2] - p_cam[..., None, :2] * cols[..., 2:] * inv_z) * inv_z
    B = torch.einsum("mij,mnj->min", derivs, plane_b)     # (M, 2, 3)
    return A, B


def lean_tiles(cfg: BundleConfig, P: int) -> int:
    """Number of point tiles of the Schur accumulation (1 = dense); dense
    unless ``cfg.soff_tiles`` divides P."""
    if cfg.soff_tiles > 1 and P % cfg.soff_tiles == 0:
        return cfg.soff_tiles
    return 1


def _accumulators(prob: BundleProblem, lay: MeasLayout, cam: atan.Camera,
                  sigma_sq: Tensor, cfg: BundleConfig, mest_kind: int):
    """Project and robustly weigh every measurement and build the LM
    normal-equation blocks (Do_LM_Step parts (i)-(ii)).

    Returns (U (C, 6, 6), ea (C, 6), V9 (P, 9), eb (P, 3), W, err, new_bad,
    good). W is (nT, 18(C+1), P/nT): point tile, row (camera, a, b) of the
    6x3 block, point in the tile, with the points P-minormost as in the
    JAX package; rows 18C.. are the dump camera's and are not read.
    """
    C, P = prob.cam_R.shape[0], prob.pt_pos.shape[0]
    M = prob.meas_cam.shape[0]
    dev = prob.pt_pos.device
    active = prob.meas_valid & ~prob.meas_bad

    p_cam, z1, eps, err_sq, bad_proj = _project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    ok = active & ~bad_proj
    w_sqrt = torch.where(ok, mest.sqrt_weight(err_sq, sigma_sq, mest_kind),
                         0.0)
    new_bad = active & (bad_proj | (w_sqrt == 0.0))
    good = active & ~new_bad
    err = (torch.sum(torch.where(
        good, mest.objective(err_sq, sigma_sq, mest_kind), 0.0))
        + torch.sum(new_bad.to(torch.float32)))

    # Mask with where(), not multiplication: a pruned NaN measurement
    # times weight 0 is still NaN and would poison every sum.
    eps_w = torch.where(good[:, None], eps * w_sqrt[:, None], 0.0)
    scale = prob.meas_sqrt_inv_noise * w_sqrt
    mc = prob.meas_cam.long().clamp(0, C - 1)
    A, B = _jacobians(p_cam, z1, prob.cam_R[mc], cam, scale)
    A = torch.where((good & ~prob.cam_fixed[mc])[:, None, None], A, 0.0)
    B = torch.where(good[:, None, None], B, 0.0)

    # U and ea: one one-hot product (dump rows are all zero), in
    # ``u_chunks`` M-chunks when they divide M.
    AtA = torch.einsum("mia,mib->mab", A, A).reshape(M, 36)
    Aeps = torch.einsum("mia,mi->ma", A, eps_w)
    AtAeps = torch.cat([AtA, Aeps], dim=-1)                  # (M, 42)
    n_chunks = cfg.u_chunks if cfg.u_chunks > 1 and M % cfg.u_chunks == 0 \
        else 1
    cams = torch.arange(C, device=dev)
    Uea = None
    for cam_c, a_c in zip(lay.cam.chunk(n_chunks), AtAeps.chunk(n_chunks)):
        part = (cam_c[:, None] == cams[None]).to(torch.float32).T @ a_c
        Uea = part if Uea is None else Uea + part
    U = Uea[:, :36].reshape(C, 6, 6)
    ea = Uea[:, 36:]

    # V and eb: each measurement's slot in its point's row, then the sum
    # over the slots.
    BtB = torch.einsum("mia,mib->mab", B, B).reshape(M, 9)
    Beps = torch.einsum("mia,mi->ma", B, eps_w)
    Veb = torch.zeros(P + 1, lay.n_pt, 12, device=dev)
    Veb[lay.pt, lay.pt_rank] = torch.cat([BtB, Beps], dim=-1)
    Veb = Veb[:P].sum(dim=1)
    V9, eb = Veb[:, :9], Veb[:, 9:]

    # W: the (camera, point) blocks, point-tiled, a slot for each repeat
    # of a pair.
    Wm = torch.einsum("mia,mib->mab", A, B).reshape(M, 18)
    nT = lean_tiles(cfg, P)
    T = P // nT
    pt = torch.where(lay.pt < P, lay.pt, 0)
    rows = lay.cam[:, None] * 18 + torch.arange(18, device=dev)[None]
    W = torch.zeros(lay.n_pair, nT, 18 * (C + 1), T, device=dev)
    W[lay.pair_rank[:, None], (pt // T)[:, None], rows, (pt % T)[:, None]] = Wm
    W = W[0] if lay.n_pair == 1 else W.sum(dim=0)
    return U, ea, V9, eb, W, err, new_bad, good


def _vinv_cols(V9: Tensor, lam) -> Tensor:
    """Per-point inverse of V* (V with the lambda-augmented diagonal) as
    (3, 3, P), [row, col, point]; zero where V is rank-deficient."""
    d = 1.0 + lam
    a = [V9[:, k] for k in range(9)]
    diag_prod = a[0] * a[4] * a[8]
    a00 = a[0] * d + 1e-12
    a01, a02 = a[1], a[2]
    a10 = a[3]
    a11 = a[4] * d + 1e-12
    a12 = a[5]
    a20, a21 = a[6], a[7]
    a22 = a[8] * d + 1e-12
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = torch.where((torch.abs(det) < 1e-30) | (diag_prod == 0.0), 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det))
    return torch.stack([torch.stack([c00, c01, c02]),
                        torch.stack([c10, c11, c12]),
                        torch.stack([c20, c21, c22])]) * inv_det


def _wv_product(W2d: Tensor, Vi: Tensor, C6: int, P: int) -> Tensor:
    """W V^-1 per point, (C6, 3P), from the (18C, P) W and (3, 3, P) Vinv:
    nine (C6, P) multiply-adds."""
    W3 = W2d.reshape(C6, 3, P)
    cols = []
    for dcol in range(3):
        acc = W3[:, 0, :] * Vi[0, dcol][None]
        acc = acc + W3[:, 1, :] * Vi[1, dcol][None]
        acc = acc + W3[:, 2, :] * Vi[2, dcol][None]
        cols.append(acc)
    return torch.cat(cols, dim=1)


def _check_float32_products(t: Tensor) -> None:
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("bundle adjustment needs float32 matrix products:"
                           " torch.backends.cuda.matmul.allow_tf32 must be "
                           "False and the float32 matmul precision "
                           "'highest'")


def lm_step(state: LMState, cam: atan.Camera,
            cfg: BundleConfig = BundleConfig(),
            mest_kind: int = mest.TUKEY) -> LMState:
    """One full LM step (Do_LM_Step): robust sigma, U/V/W accumulation,
    the lambda-retry loop, accept, outlier pruning."""
    return lm_step_flags(state, cam, cfg, mest_kind)[0]


def lm_step_flags(state: LMState, cam: atan.Camera,
                  cfg: BundleConfig = BundleConfig(),
                  mest_kind: int = mest.TUKEY):
    """``lm_step`` and the new state's (converged, iters, failed,
    accepted), as ``flags`` gives them, from the last lambda try's host
    read: one read a try, none after."""
    prob, lay = state.problem, state.layout
    _check_float32_products(prob.pt_pos)
    parts = _step_parts(prob, lay, cam, cfg, mest_kind)
    camsys = _camera_system(prob)

    def try_lambda(lam):
        Vi, L, info, rhs = _factor_try(parts, camsys, lam)
        return _finish_try(prob, parts, Vi, _solve_factored(L, info, rhs,
                                                            camsys),
                           cam, mest_kind)

    return _retry_and_accept(state, cfg, try_lambda, parts.current_error,
                             parts.new_bad)


@dataclasses.dataclass
class StepParts:
    """What every lambda try of a step shares: the robust sigma, the
    normal-equation blocks (``_accumulators``) and the step's error and
    outlier masks."""
    active: Tensor
    sigma_sq: Tensor
    U: Tensor
    ea: Tensor
    V9: Tensor
    eb: Tensor
    W: Tensor
    current_error: Tensor
    new_bad: Tensor
    good: Tensor


def _step_parts(prob: BundleProblem, lay: MeasLayout, cam: atan.Camera,
                cfg: BundleConfig, mest_kind: int) -> StepParts:
    """(i) the robust sigma and (ii) the jacobians and accumulators."""
    active = prob.meas_valid & ~prob.meas_bad
    _, _, _, err_sq, bad_proj = _project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    sigma_sq = mest.find_sigma_squared(err_sq, active & ~bad_proj, mest_kind,
                                       min_sigma=cfg.min_sigma)
    return StepParts(active, sigma_sq, *_accumulators(
        prob, lay, cam, sigma_sq, cfg, mest_kind))


def _factor_try(parts: StepParts, camsys, lam):
    """A lambda try up to the Cholesky factor of the reduced camera
    system: (Vi (3, 3, P), L, info, rhs) (``_factor_cameras``)."""
    W, eb = parts.W, parts.eb
    nT, T = W.shape[0], W.shape[2]
    C = parts.U.shape[0]
    C6 = C * 6
    Vi = _vinv_cols(parts.V9, lam)                        # (3, 3, P)
    Vi_tiles = Vi.reshape(3, 3, nT, T)
    eb_tiles = eb.T.reshape(3, nT, T)
    S_off, rcorr = None, None
    for t in range(nT):
        Wt = W[t, :18 * C]                                # (18C, T)
        WVt = _wv_product(Wt, Vi_tiles[:, :, t], C6, T)
        s = WVt @ Wt.reshape(C6, 3 * T).T
        r = WVt @ eb_tiles[:, t].reshape(-1)
        S_off = s if S_off is None else S_off + s
        rcorr = r if rcorr is None else rcorr + r
    return (Vi,) + _factor_cameras(camsys, S_off, rcorr, parts.U, parts.ea,
                                   lam)


def _finish_try(prob: BundleProblem, parts: StepParts, Vi: Tensor,
                delta_cam: Tensor, cam: atan.Camera, mest_kind: int):
    """The rest of a lambda try from the camera update: back-substitute
    the points and measure the trial. Returns (new_R, new_t, new_pt,
    upd_sq, new_error)."""
    W, eb = parts.W, parts.eb
    nT, T = W.shape[0], W.shape[2]
    C6 = delta_cam.shape[0] * 6
    C = delta_cam.shape[0]
    corr = torch.cat([(delta_cam.reshape(-1) @ W[t, :18 * C].reshape(
        C6, 3 * T)).reshape(3, T) for t in range(nT)], dim=1)
    delta_pt = _back_substitute(Vi, eb.T - corr, prob.pt_valid)
    upd_sq = torch.sum(delta_cam ** 2) + torch.sum(delta_pt ** 2)
    new_R, new_t, new_pt, new_error = _trial(
        prob, delta_cam, delta_pt, cam, parts.sigma_sq, mest_kind,
        parts.good, parts.new_bad, parts.active)
    return new_R, new_t, new_pt, upd_sq, new_error


def _camera_system(prob: BundleProblem):
    """What every lambda try of a step shares in the reduced camera system:
    the free cameras (float), the free-pair block mask and the identity
    blocks of fixed or invalid cameras."""
    C = prob.cam_R.shape[0]
    dev = prob.pt_pos.device
    free_f = (prob.cam_valid & ~prob.cam_fixed).to(torch.float32)
    eye6 = torch.eye(6, device=dev)
    eyeC = torch.eye(C, device=dev)
    blk = free_f[:, None, None, None] * free_f[None, None, :, None]
    # Fixed or invalid cameras: an identity block and zero rhs.
    fixed_eye = (torch.einsum("jab,jk->jakb", eye6.expand(C, 6, 6), eyeC)
                 * (1.0 - free_f)[:, None, None, None])
    return free_f, blk, fixed_eye, eye6, eyeC


def _solve_cameras(camsys, S_off: Tensor, rcorr: Tensor, U: Tensor,
                   ea: Tensor, lam) -> Tensor:
    """The camera update (C, 6) from the Schur product S_off = W V*^-1 W^T
    (6C, 6C) and its rhs correction (6C,): S = U* - S_off solved by
    Cholesky."""
    return _solve_factored(*_factor_cameras(camsys, S_off, rcorr, U, ea,
                                            lam), camsys)


def _factor_cameras(camsys, S_off: Tensor, rcorr: Tensor, U: Tensor,
                    ea: Tensor, lam):
    """The Cholesky factor of S + 1e-8 I, S = U* - S_off, its info and the
    right-hand side: (L (6C, 6C), info, rhs (6C, 1))."""
    free_f, blk, fixed_eye, eye6, eyeC = camsys
    C = U.shape[0]
    C6 = 6 * C
    dev = U.device
    rhs = ea - rcorr.reshape(C, 6)
    Ustar = U * (torch.ones(6, 6, device=dev) + lam * eye6)
    S = -S_off.reshape(C, 6, C, 6) + torch.einsum("jab,jk->jakb", Ustar,
                                                  eyeC)
    S = S * blk + fixed_eye
    rhs = rhs * free_f[:, None]
    # A factorisation that fails (S not SPD) gives a NaN solve, as JAX's
    # does, and no exception or host sync.
    L, info = torch.linalg.cholesky_ex(
        S.reshape(C6, C6) + 1e-8 * torch.eye(C6, device=dev))
    return L, info, rhs.reshape(C6, 1)


def _solve_factored(L: Tensor, info: Tensor, rhs: Tensor, camsys) -> Tensor:
    """The camera update (C, 6) from ``_factor_cameras``. (cuSOLVER's
    ``cholesky_solve`` cannot sit in a CUDA graph's conditional body, and
    two triangular solves round otherwise on the card: ``lm_chunk`` calls
    this outside its try slots' bodies.)"""
    free_f = camsys[0]
    delta_cam = torch.cholesky_solve(rhs, L)
    delta_cam = torch.where(info == 0, delta_cam, float("nan"))
    return delta_cam.reshape(-1, 6) * free_f[:, None]


def _back_substitute(Vi: Tensor, rb: Tensor, pt_valid: Tensor) -> Tensor:
    """The point updates (P, 3) = V*^-1 (eb - W^T delta_cam), from ``rb``
    (3, P)."""
    delta_pt = torch.stack(
        [Vi[a, 0] * rb[0] + Vi[a, 1] * rb[1] + Vi[a, 2] * rb[2]
         for a in range(3)], dim=1)
    return delta_pt * pt_valid[:, None]


def _trial(prob: BundleProblem, delta_cam, delta_pt, cam, sigma_sq,
           mest_kind, good, new_bad, active):
    """The trial state and its robust error (FindNewError) over
    ``prob``'s measurements: (new_R, new_t, new_pt, error)."""
    d_pose = se3lib.se3_exp(delta_cam)
    new_R = d_pose.R @ prob.cam_R
    new_t = (d_pose.R @ prob.cam_t[..., None])[..., 0] + d_pose.t
    new_pt = prob.pt_pos + delta_pt
    _, _, _, new_err_sq, nb = _project_meas(new_R, new_t, new_pt, prob, cam)
    new_error = (torch.sum(torch.where(
        good & ~nb, mest.objective(new_err_sq, sigma_sq, mest_kind), 0.0))
        + torch.sum((new_bad | (active & nb)).to(torch.float32)))
    return new_R, new_t, new_pt, new_error


def _take_try(c: "_Carry", cfg: BundleConfig, current_error: Tensor,
              new_R, new_t, new_pt, upd_sq, new_error) -> Tensor:
    """A lambda try's outcome, set in the carry ``c`` (its cam_R, cam_t,
    pt_pos, lam, lam_factor, converged, failed, accepted, iters and
    last_error): a try that does not lower the step's error raises
    lambda (ModifyLambda_BadStep) and retries, NaN or inf trial errors
    counting as not improved; one that lowers it is accepted and lowers
    lambda (ModifyLambda_GoodStep). Device ``torch.where``s only, so that
    the host loop of a step (``_retry_and_accept``) and a chunk's try
    slots (``_chunk``) share them. Returns ``retry`` (0-dim bool)."""
    conv = upd_sq < cfg.update_squared_convergence_limit
    # Numerical failure: no finite error even after lambda escalation, or
    # a non-finite baseline: the map is probably corrupt.
    failed = (~torch.isfinite(new_error) | ~torch.isfinite(current_error)
              | ~torch.isfinite(upd_sq))
    improved = new_error < current_error
    accept = improved & ~failed
    iters = c.iters + 1
    retry = ~improved & ~conv & (iters < cfg.max_iterations)
    lam, lam_factor = c.lam, c.lam_factor
    lf2 = lam_factor * 2.0
    c.set(lam=torch.where(retry, lam * lf2, torch.where(
              accept, torch.clamp(lam * cfg.lambda_good_mult, min=1e-10),
              lam)),
          lam_factor=torch.where(retry, lf2, torch.where(
              accept, cfg.lambda_factor_initial, lam_factor)),
          cam_R=torch.where(accept, new_R, c.cam_R),
          cam_t=torch.where(accept, new_t, c.cam_t),
          pt_pos=torch.where(accept, new_pt, c.pt_pos),
          converged=c.converged | conv, failed=c.failed | (failed & ~retry),
          accepted=c.accepted + accept.to(torch.int32), iters=iters,
          last_error=new_error)
    return retry


def _retry_and_accept(state: LMState, cfg: BundleConfig, try_lambda,
                      current_error: Tensor, new_bad: Tensor):
    """The lambda loop of a step and its outcome (``_take_try``):
    ``try_lambda(lam)`` gives (new_R, new_t, new_pt, upd_sq, new_error),
    each try read on the host once. Returns (the new LMState, its
    flags)."""
    prob = state.problem
    c = _Carry(False, cam_R=prob.cam_R, cam_t=prob.cam_t, pt_pos=prob.pt_pos,
               lam=state.lam, lam_factor=state.lam_factor,
               converged=state.converged, accepted=state.accepted,
               iters=state.iters, last_error=state.last_error,
               failed=state.failed)
    while True:
        retry = _take_try(c, cfg, current_error, *try_lambda(c.lam))
        # The try's one host read: whether to retry, and the flags.
        read = torch.stack([retry.to(torch.int32), c.converged.to(torch.int32),
                            c.iters, c.failed.to(torch.int32),
                            c.accepted]).tolist()
        if not read[0]:
            break
    new_prob = dataclasses.replace(prob, cam_R=c.cam_R, cam_t=c.cam_t,
                                   pt_pos=c.pt_pos,
                                   meas_bad=prob.meas_bad | new_bad)
    return LMState(problem=new_prob, layout=state.layout, lam=c.lam,
                   lam_factor=c.lam_factor, converged=c.converged,
                   accepted=c.accepted, iters=c.iters,
                   last_error=c.last_error, failed=c.failed), tuple(read[1:])


#: ``flags`` of ``init_lm``'s state.
INIT_FLAGS = (0, 0, 0, 0)


def flags(state: LMState):
    """(converged, iters, failed, accepted) as Python ints: one host read."""
    return tuple(torch.stack([state.converged.to(torch.int32), state.iters,
                              state.failed.to(torch.int32),
                              state.accepted]).tolist())


class _Carry:
    """Values a chunk carries from one try slot to the next. Eagerly ``set``
    rebinds a name; on the device (a capture, its warm-up or an emulated
    replay) it writes into the tensor the name first held (a copy of the first
    value set), so a replay that skips the write keeps the last one."""

    def __init__(self, in_place: bool, **values):
        self._in_place = in_place
        self.__dict__.update(values)

    def set(self, **values):
        for name, value in values.items():
            held = self.__dict__.get(name)
            if not self._in_place:
                self.__dict__[name] = value
            elif held is None:
                self.__dict__[name] = value.clone()
            else:
                held.copy_(value)


_PARTS = tuple(f.name for f in dataclasses.fields(StepParts))


def _chunk(state: LMState, cam: atan.Camera, cfg: BundleConfig,
           mest_kind: int, iter_limit, f):
    """``lm_chunk`` as try slots (the module's docstring). With ``f`` (the
    state's host flags) it runs eagerly and returns (new state, flags);
    with ``f`` None it runs on the card's predicates (a capture, its
    warm-up or an emulated replay; ``iter_limit`` an int32 0-dim tensor),
    writes the state's tensors in place and returns the (4,) int32
    flags."""
    prob, lay = state.problem, state.layout
    _check_float32_products(prob.pt_pos)
    on_device = f is None
    c = _Carry(on_device, cam_R=prob.cam_R, cam_t=prob.cam_t,
               pt_pos=prob.pt_pos, meas_bad=prob.meas_bad, lam=state.lam,
               lam_factor=state.lam_factor, converged=state.converged,
               accepted=state.accepted, iters=state.iters,
               last_error=state.last_error, failed=state.failed)
    camsys = _camera_system(prob)
    if on_device:
        run = (~state.converged & ~state.failed & (state.iters < iter_limit))
        start = torch.ones((), dtype=torch.bool, device=run.device)
        # A warm-up reaches every body in one slot.
        slots = range(1 if graphs.warming() else cfg.max_iterations)
    else:
        conv, iters, failed, _ = f
        run, start = not (conv or failed or iters >= iter_limit), True
        slots = itertools.count()
    for _ in slots:
        with graphs.if_block(run) as go:
            if go:
                with graphs.if_block(start) as go_start:
                    if go_start:
                        base = dataclasses.replace(
                            prob, cam_R=c.cam_R, cam_t=c.cam_t,
                            pt_pos=c.pt_pos, meas_bad=c.meas_bad)
                        parts = _step_parts(base, lay, cam, cfg, mest_kind)
                        c.set(meas_bad=c.meas_bad | parts.new_bad,
                              **{n: getattr(parts, n) for n in _PARTS})
                parts = StepParts(*(getattr(c, n) for n in _PARTS))
                Vi, L, info, rhs = _factor_try(parts, camsys, c.lam)
                c.set(Vi=Vi, L=L, info=info, rhs=rhs)
        # The solve outside the bodies: a slot that does not run solves
        # the last factor again, for nothing.
        if on_device or run:
            c.set(delta_cam=_solve_factored(c.L, c.info, c.rhs, camsys))
        with graphs.if_block(run) as go:
            if go:
                parts = StepParts(*(getattr(c, n) for n in _PARTS))
                base = dataclasses.replace(prob, cam_R=c.cam_R,
                                           cam_t=c.cam_t, pt_pos=c.pt_pos)
                retry = _take_try(c, cfg, parts.current_error, *_finish_try(
                    base, parts, c.Vi, c.delta_cam, cam, mest_kind))
                more = retry | (~c.converged & ~c.failed
                                & (c.iters < iter_limit))
                if on_device:
                    run.copy_(more)
                    start.copy_(~retry)
                else:
                    # The try's one host read.
                    read = torch.stack([
                        more.to(torch.int32), retry.to(torch.int32),
                        c.converged.to(torch.int32), c.iters,
                        c.failed.to(torch.int32), c.accepted]).tolist()
                    run, start, f = bool(read[0]), not read[1], \
                        tuple(read[2:])
        if not (on_device or run):
            break
    if on_device:
        return torch.stack([c.converged.to(torch.int32), c.iters,
                            c.failed.to(torch.int32), c.accepted])
    new_prob = dataclasses.replace(prob, cam_R=c.cam_R, cam_t=c.cam_t,
                                   pt_pos=c.pt_pos, meas_bad=c.meas_bad)
    return LMState(problem=new_prob, layout=lay, lam=c.lam,
                   lam_factor=c.lam_factor, converged=c.converged,
                   accepted=c.accepted, iters=c.iters,
                   last_error=c.last_error, failed=c.failed), f


def lm_chunk(state: LMState, cam: atan.Camera, cfg: BundleConfig,
             mest_kind: int, iter_limit: int, f):
    """Steps until converged, failed or ``iter_limit`` inner iterations
    (JAX's device loop of steps), as try slots run eagerly: one host
    read a try. ``f`` is the ``flags`` of ``state``, which the
    caller holds (``INIT_FLAGS``, or the last chunk's). Returns (state,
    flags)."""
    conv, iters, failed, _ = f
    if conv or failed or iters >= iter_limit:
        return state, f
    return _chunk(state, cam, cfg, mest_kind, iter_limit, f)


def _fields(obj) -> tuple:
    """A dataclass's field values, not copied (``dataclasses.astuple``
    deep-copies them)."""
    return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))


def _state_tensors(state: LMState) -> tuple:
    return (_fields(state.problem)
            + (state.layout.cam, state.layout.pt, state.layout.pt_rank,
               state.layout.pair_rank, state.lam, state.lam_factor,
               state.converged, state.accepted, state.iters,
               state.last_error, state.failed))


class ChunkProgram(graphs.Program):
    """``lm_chunk`` as one CUDA graph (JAX's ``_cached_lm_chunk``) at one
    problem shape (cameras, points, measurements), ``MeasLayout`` (n_pt,
    n_pair), config and estimator (``key_of``): ``cfg.max_iterations``
    try slots under IF nodes, the iteration limit a static input, the
    state's static buffers written in place, and one host read of the
    flags a chunk. On the CPU, or with ``graphs=False``, ``lm_chunk`` runs
    on the buffers and its result is copied into them. A call returns the
    buffers: the next call overwrites them."""

    def __init__(self, state: LMState, cam: atan.Camera, cfg: BundleConfig,
                 mest_kind: int, graphs: bool = True,
                 debug_path: str | None = None, pool=None):
        super().__init__(state.problem.pt_pos.device, graphs, debug_path,
                         pool)
        self.key = self.key_of(state, cfg, mest_kind)
        self.cam, self.cfg, self.kind = cam, cfg, mest_kind
        lay = state.layout
        self.state = LMState(
            problem=BundleProblem(*(t.clone()
                                    for t in _fields(state.problem))),
            layout=MeasLayout(lay.cam.clone(), lay.pt.clone(),
                              lay.pt_rank.clone(), lay.pair_rank.clone(),
                              lay.n_pt, lay.n_pair),
            **{k: getattr(state, k).clone() for k in (
                "lam", "lam_factor", "converged", "accepted", "iters",
                "last_error", "failed")})
        self.limit = torch.zeros((), dtype=torch.int32, device=self.device)

    @staticmethod
    def key_of(state: LMState, cfg: BundleConfig, mest_kind: int):
        p = state.problem
        return (p.cam_R.shape[0], p.pt_pos.shape[0], p.meas_cam.shape[0],
                state.layout.n_pt, state.layout.n_pair, cfg, mest_kind)

    def _inputs(self):
        return (self.state, self.limit)

    def _fn(self, state, limit):
        return _chunk(state, self.cam, self.cfg, self.kind, limit, None)

    def __call__(self, state: LMState, iter_limit: int, f):
        """``lm_chunk(state, ..., iter_limit, f)``; ``state`` may be this
        program's buffers (the last call's result), which are then not
        copied."""
        conv, iters, failed, _ = f
        if conv or failed or iters >= iter_limit:
            return state, f
        if iter_limit > self.cfg.max_iterations:
            raise ValueError(f"iter_limit {iter_limit} past max_iterations "
                             f"{self.cfg.max_iterations}: more tries than "
                             "the graph's slots")
        bufs = _state_tensors(self.state)
        for buf, x in zip(bufs, _state_tensors(state)):
            graphs.fill(buf, x)
        if not self.graphs:
            out, f = lm_chunk(self.state, self.cam, self.cfg, self.kind,
                              iter_limit, f)
            for buf, x in zip(bufs, _state_tensors(out)):
                graphs.fill(buf, x)
            return self.state, f
        self.limit.fill_(iter_limit)
        flags_t = self.run()
        return self.state, tuple(flags_t.tolist())


def compute(problem: BundleProblem, cam: atan.Camera,
            cfg: BundleConfig = BundleConfig(),
            mest_kind: int = mest.TUKEY, abort_check=None,
            max_steps: int | None = None, steps_per_dispatch: int = 5,
            return_flags: bool = False):
    """Run LM to convergence (Bundle::Compute) in chunks of
    ``steps_per_dispatch`` inner iterations, polling ``abort_check``
    between chunks. ``max_steps`` bounds this call's inner iterations below
    ``cfg.max_iterations``.

    Returns (final LMState, n_chunks); with ``return_flags=True`` also the
    (converged, iters, failed, accepted) of the last read.
    """
    state = init_lm(problem, cfg)
    limit = cfg.max_iterations if max_steps is None \
        else min(max_steps, cfg.max_iterations)
    n = 0
    f = conv, iters, failed, accepted = INIT_FLAGS
    while iters < limit:
        state, f = lm_chunk(state, cam, cfg, mest_kind,
                            min(iters + steps_per_dispatch, limit), f)
        conv, iters, failed, accepted = f
        n += 1
        if conv or failed:
            # failed: a numerical blow-up; the caller must ditch the map.
            break
        if abort_check is not None and abort_check():
            break
    if return_flags:
        return state, n, (bool(conv), iters, bool(failed), accepted)
    return state, n


def residual_rms(problem: BundleProblem, cam: atan.Camera) -> Tensor:
    """RMS reprojection error (pixels, noise-scaled) of the active
    measurements."""
    _, _, _, err_sq, bad = _project_meas(
        problem.cam_R, problem.cam_t, problem.pt_pos, problem, cam)
    ok = problem.meas_valid & ~problem.meas_bad & ~bad
    n = torch.clamp(torch.sum(ok.to(torch.float32)), min=1.0)
    return torch.sqrt(torch.sum(torch.where(ok, err_sq, 0.0)) / n)
