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

JAX runs the lambda retries as a device ``while_loop``; here the host reads
one flag vector a lambda try (``lm_step_flags``): whether to retry, and
the step's flags should it not, which the steps of a chunk
(``lm_chunk``) go on. A step with n retries reads n + 1 times.

Matrix products must be float32: ``lm_step`` raises on a card that allows
TF32 (the JAX package pins float32 for the same reason: reduced-precision
products corrupt the normal equations).
"""

from __future__ import annotations

import dataclasses

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import BundleConfig
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
    n_pt: int         # the most measurements a point has (>= 1)
    n_pair: int       # the most measurements a pair has (>= 1)


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


def measurement_layout(prob: BundleProblem) -> MeasLayout:
    """The accumulator slots of ``prob``'s measurements; reads the two
    largest ranks on the host (the one host read of a BA problem)."""
    C, P = prob.cam_R.shape[0], prob.pt_pos.shape[0]
    mc, mp = prob.meas_cam.long(), prob.meas_pt.long()
    live = prob.meas_valid & (mc >= 0) & (mc < C) & (mp >= 0) & (mp < P)
    cam = torch.where(live, mc, C)
    pt = torch.where(live, mp, P)
    pt_rank = torch.where(live, _run_rank(pt), 0)
    pair_rank = torch.where(live, _run_rank(cam * (P + 1) + pt), 0)
    n_pt, n_pair = (torch.stack([pt_rank.max(), pair_rank.max()]) + 1).tolist()
    return MeasLayout(cam=cam, pt=pt, pt_rank=pt_rank, pair_rank=pair_rank,
                      n_pt=n_pt, n_pair=n_pair)


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
    C = prob.cam_R.shape[0]
    C6 = C * 6
    active = prob.meas_valid & ~prob.meas_bad

    # ---- (i) robust sigma ----
    _, _, _, err_sq, bad_proj = _project_meas(
        prob.cam_R, prob.cam_t, prob.pt_pos, prob, cam)
    sigma_sq = mest.find_sigma_squared(err_sq, active & ~bad_proj, mest_kind,
                                       min_sigma=cfg.min_sigma)

    # ---- (ii) jacobians and accumulators ----
    U, ea, V9, eb, W, current_error, new_bad, good = _accumulators(
        prob, lay, cam, sigma_sq, cfg, mest_kind)
    nT, T = W.shape[0], W.shape[2]
    W_tiles = [W[t, :18 * C] for t in range(nT)]          # (18C, T) views
    eb_tiles = eb.T.reshape(3, nT, T)

    camsys = _camera_system(prob)

    def try_lambda(lam):
        Vi = _vinv_cols(V9, lam)                          # (3, 3, P)
        Vi_tiles = Vi.reshape(3, 3, nT, T)
        S_off, rcorr = None, None
        for t in range(nT):
            WVt = _wv_product(W_tiles[t], Vi_tiles[:, :, t], C6, T)
            s = WVt @ W_tiles[t].reshape(C6, 3 * T).T
            r = WVt @ eb_tiles[:, t].reshape(-1)
            S_off = s if S_off is None else S_off + s
            rcorr = r if rcorr is None else rcorr + r
        delta_cam = _solve_cameras(camsys, S_off, rcorr, U, ea, lam)

        # Back-substitute the point updates.
        corr = torch.cat([(delta_cam.reshape(-1) @ W_tiles[t].reshape(
            C6, 3 * T)).reshape(3, T) for t in range(nT)], dim=1)
        delta_pt = _back_substitute(Vi, eb.T - corr, prob.pt_valid)

        upd_sq = torch.sum(delta_cam ** 2) + torch.sum(delta_pt ** 2)
        new_R, new_t, new_pt, new_error = _trial(
            prob, delta_cam, delta_pt, cam, sigma_sq, mest_kind, good,
            new_bad, active)
        return new_R, new_t, new_pt, upd_sq, new_error

    return _retry_and_accept(state, cfg, try_lambda, current_error, new_bad)


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

    # Cholesky of S + 1e-8 I; a factorisation that fails (S not SPD)
    # gives a NaN solve, as JAX's does, and no exception or host sync.
    L, info = torch.linalg.cholesky_ex(
        S.reshape(C6, C6) + 1e-8 * torch.eye(C6, device=dev))
    delta_cam = torch.cholesky_solve(rhs.reshape(C6, 1), L)
    delta_cam = torch.where(info == 0, delta_cam, float("nan"))
    return delta_cam.reshape(C, 6) * free_f[:, None]


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


def _retry_and_accept(state: LMState, cfg: BundleConfig, try_lambda,
                      current_error: Tensor, new_bad: Tensor):
    """The lambda loop of a step and its outcome: ``try_lambda(lam)`` gives
    (new_R, new_t, new_pt, upd_sq, new_error); a try that does not lower
    the error raises lambda and retries, each try read on the host once.
    Returns (the new LMState, its flags)."""
    prob = state.problem
    lam, lam_factor = state.lam, state.lam_factor
    n_inner = 0
    while True:
        n_inner += 1
        new_R, new_t, new_pt, upd_sq, new_error = try_lambda(lam)
        conv = upd_sq < cfg.update_squared_convergence_limit
        # Numerical failure: no finite error even after lambda escalation,
        # or a non-finite baseline: the map is probably corrupt.
        failed = (~torch.isfinite(new_error) | ~torch.isfinite(current_error)
                  | ~torch.isfinite(upd_sq))
        accept = (new_error < current_error) & ~failed
        # A bad step raises lambda (ModifyLambda_BadStep) and retries; NaN
        # or inf trial errors count as not improved.
        retry = (~(new_error < current_error) & ~conv
                 & (state.iters + n_inner < cfg.max_iterations))
        converged = state.converged | conv
        iters = state.iters + n_inner
        failed_all = state.failed | failed
        accepted = state.accepted + accept.to(torch.int32)
        # The try's one host read: whether to retry, and the flags.
        read = torch.stack([retry.to(torch.int32), converged.to(torch.int32),
                            iters, failed_all.to(torch.int32),
                            accepted]).tolist()
        if not read[0]:
            break
        lam_factor = lam_factor * 2.0
        lam = lam * lam_factor

    # Good step: lambda *= 0.3, factor reset (ModifyLambda_GoodStep).
    lam = torch.where(accept, torch.clamp(lam * cfg.lambda_good_mult,
                                          min=1e-10), lam)
    lam_factor = torch.where(accept, cfg.lambda_factor_initial, lam_factor)

    new_prob = dataclasses.replace(
        prob, cam_R=torch.where(accept, new_R, prob.cam_R),
        cam_t=torch.where(accept, new_t, prob.cam_t),
        pt_pos=torch.where(accept, new_pt, prob.pt_pos),
        meas_bad=prob.meas_bad | new_bad)
    return LMState(problem=new_prob, layout=state.layout, lam=lam,
                   lam_factor=lam_factor, converged=converged,
                   accepted=accepted, iters=iters, last_error=new_error,
                   failed=failed_all), tuple(read[1:])


#: ``flags`` of ``init_lm``'s state.
INIT_FLAGS = (0, 0, 0, 0)


def flags(state: LMState):
    """(converged, iters, failed, accepted) as Python ints: one host read."""
    return tuple(torch.stack([state.converged.to(torch.int32), state.iters,
                              state.failed.to(torch.int32),
                              state.accepted]).tolist())


def lm_chunk(state: LMState, cam: atan.Camera, cfg: BundleConfig,
             mest_kind: int, iter_limit: int, f):
    """Steps until converged, failed or ``iter_limit`` inner iterations
    (JAX's device loop of steps). ``f`` is the ``flags`` of ``state``,
    which the caller holds (``INIT_FLAGS``, or the last chunk's). Returns
    (state, flags); the host reads only in the lambda tries."""
    while True:
        conv, iters, failed, _ = f
        if conv or failed or iters >= iter_limit:
            return state, f
        state, f = lm_step_flags(state, cam, cfg, mest_kind)


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
