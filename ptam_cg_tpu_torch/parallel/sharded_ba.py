"""Point-sharded global bundle adjustment over ``torch.distributed`` (port
of ``ptam_cg_tpu.parallel.sharded_ba``).

Every rank of a ``Mesh`` (``parallel/mesh.py``) runs the same code on the
same inputs, as JAX's processes do. Cameras are replicated; rank r owns
the points ``[r*Pl, (r+1)*Pl)`` and the measurements of those points,
which ``shard_problem`` groups by owner on the host and pads per shard to
one common count (``_MEAS_PAD``). ``meas_pt`` stays a global point index,
so a checkpoint re-shards onto any world size that divides the point
capacity. What crosses ranks are camera-sized blocks:

per LM step      U (36C) + ea (6C) + the error        [one all_reduce]
                 the squared residuals for the robust [one all_gather,
                 sigma, -1 where not counted          M scalars]
per lambda try   S_off partial (36C^2) + rhs          [one all_reduce]
                 correction (6C)
                 point-update norm + trial error      [one all_reduce,
                                                       2 scalars]

V (P, 3, 3), eb and the W blocks stay on their rank: each rank forms its
(6C)^2 partial of S_off = sum_p W_p V*_p^-1 W_p^T as one matrix product
from its own points, and back-substitutes its own points. The (6C)^2
Cholesky runs on every rank on the same reduced system (``soff_tiles``
and ``u_chunks`` are forced off, as in the JAX package: the shards divide
the working set already). Each rank's accumulators use a ``MeasLayout`` of
its own shard, so V and W stay repeatable bit for bit.

The lambda loop reads its condition on the host from the all-reduced
errors and update norm, so every rank takes the same branch; an
``abort_check`` is agreed over the ranks (any rank's abort stops all).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.config import BundleConfig
from ptam_cg_tpu_torch.models import bundle as bundlelib
from ptam_cg_tpu_torch.models.bundle import BundleProblem, LMState
from ptam_cg_tpu_torch.parallel.mesh import Mesh
from ptam_cg_tpu_torch.utils import mest

Tensor = torch.Tensor

#: Per-shard measurement capacity is padded to this multiple (the JAX
#: package's, so both packages shard a problem alike).
_MEAS_PAD = 128

_MEAS_FIELDS = ("meas_cam", "meas_pt", "meas_pos", "meas_sqrt_inv_noise",
                "meas_valid", "meas_bad")


def _shard_permutation(meas_pt: np.ndarray, meas_valid: np.ndarray,
                       points_per_shard: int, n_shards: int
                       ) -> Tuple[np.ndarray, int]:
    """Group measurements by owning point shard.

    Returns ``(perm, per_shard)`` where ``perm`` has length
    ``n_shards * per_shard``; entry j holds the original measurement index
    placed at slot j, or -1 for padding.
    """
    owner = np.where(meas_valid, meas_pt // points_per_shard, -1)
    counts = np.bincount(owner[owner >= 0], minlength=n_shards)
    per_shard = max(int(counts.max()) if counts.size else 1, 1)
    per_shard = -(-per_shard // _MEAS_PAD) * _MEAS_PAD
    perm = np.full(n_shards * per_shard, -1, np.int64)
    for d in range(n_shards):
        idx = np.nonzero(owner == d)[0]
        perm[d * per_shard:d * per_shard + len(idx)] = idx
    return perm, per_shard


def shard_problem(problem: BundleProblem, mesh: Mesh, axis: str | None = None,
                  return_perm: bool = False):
    """This rank's shard of ``problem`` (which every rank holds whole):
    the cameras, points ``[r*Pl, (r+1)*Pl)`` and the measurements of those
    points in the shard-grouped order of ``_shard_permutation`` (padding:
    invalid, at the shard's first point, noise 1). ``meas_pt`` stays
    global. Reads ``meas_pt`` and ``meas_valid`` on the host.

    The point capacity must divide the mesh size. ``axis`` (JAX's
    signature) must name the mesh's axis when given."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, not {axis!r}")
    D = mesh.size
    Pn = problem.pt_pos.shape[0]
    if Pn % D != 0:
        raise ValueError(
            f"point capacity {Pn} not divisible by mesh size {D}")
    Pl = Pn // D
    perm, per_shard = _shard_permutation(
        problem.meas_pt.cpu().numpy(), problem.meas_valid.cpu().numpy(),
        Pl, D)
    r = mesh.rank
    mine = perm[r * per_shard:(r + 1) * per_shard]
    dev = problem.pt_pos.device
    take = torch.from_numpy(np.maximum(mine, 0)).to(dev)
    pad = torch.from_numpy(mine < 0).to(dev)

    def reord(a, pad_val):
        return torch.where(pad, torch.as_tensor(pad_val, dtype=a.dtype,
                                                device=dev), a[take])

    out = BundleProblem(
        cam_R=problem.cam_R, cam_t=problem.cam_t,
        cam_fixed=problem.cam_fixed, cam_valid=problem.cam_valid,
        pt_pos=problem.pt_pos[r * Pl:(r + 1) * Pl].clone(),
        pt_valid=problem.pt_valid[r * Pl:(r + 1) * Pl].clone(),
        meas_cam=reord(problem.meas_cam.to(torch.int32), 0),
        meas_pt=reord(problem.meas_pt.to(torch.int32), r * Pl),
        meas_pos=torch.where(pad[:, None], 0.0,
                             problem.meas_pos[take]).to(torch.float32),
        meas_sqrt_inv_noise=reord(
            problem.meas_sqrt_inv_noise.to(torch.float32), 1.0),
        meas_valid=reord(problem.meas_valid, False),
        meas_bad=reord(problem.meas_bad, False))
    if return_perm:
        return out, perm
    return out


def _localized(prob: BundleProblem, mesh: Mesh) -> BundleProblem:
    """The shard with ``meas_pt`` as an index into its own points."""
    Pl = prob.pt_pos.shape[0]
    return dataclasses.replace(prob, meas_pt=prob.meas_pt - mesh.rank * Pl)


def init_sharded_lm(shard: BundleProblem, mesh: Mesh,
                    cfg: BundleConfig = BundleConfig()) -> LMState:
    """The LM start state of a shard: ``bundle.init_lm`` with the
    measurement layout of the shard's own points (one host read)."""
    layout = bundlelib.measurement_layout(_localized(shard, mesh))
    return bundlelib.init_lm(shard, cfg, layout=layout)


def _gather_bool(mesh: Mesh, t: Tensor) -> Tensor:
    # gloo reduces no bool tensors: through uint8.
    return mesh.all_gather(t.to(torch.uint8)).bool()


def unshard_measurements(original: BundleProblem, sharded: BundleProblem,
                         perm: np.ndarray, mesh: Mesh) -> BundleProblem:
    """``original`` with the shards' cameras, points, and measurement flags
    put back in its measurement order (padding dropped), on every rank:
    one all_gather of the points and flags."""
    Pl = sharded.pt_pos.shape[0]
    per = sharded.meas_bad.shape[0]
    packed = torch.cat([sharded.pt_pos.reshape(-1),
                        sharded.meas_bad.to(torch.float32),
                        sharded.meas_valid.to(torch.float32)])
    rows = mesh.all_gather(packed).reshape(mesh.size, -1)
    pt_pos = rows[:, :3 * Pl].reshape(-1, 3)
    bad = rows[:, 3 * Pl:3 * Pl + per].reshape(-1) > 0.5
    valid = rows[:, 3 * Pl + per:].reshape(-1) > 0.5
    dev = original.pt_pos.device
    live = torch.from_numpy(np.nonzero(perm >= 0)[0]).to(dev)
    dst = torch.from_numpy(perm[perm >= 0]).to(dev)
    m_bad = original.meas_bad.clone()
    m_valid = original.meas_valid.clone()
    m_bad[dst] = bad[live]
    m_valid[dst] = valid[live]
    return dataclasses.replace(original, cam_R=sharded.cam_R,
                               cam_t=sharded.cam_t, pt_pos=pt_pos,
                               meas_bad=m_bad, meas_valid=m_valid)


def gather_sharded_problem(sharded: BundleProblem,
                           mesh: Mesh) -> BundleProblem:
    """The whole shard-ordered problem (every shard's points and
    measurements, global ``meas_pt``) on every rank: what a checkpoint
    holds, as the JAX package's sharded ``LMState`` does."""
    def gather(t):
        return (_gather_bool(mesh, t) if t.dtype == torch.bool
                else mesh.all_gather(t))

    return dataclasses.replace(
        sharded, pt_pos=gather(sharded.pt_pos),
        pt_valid=gather(sharded.pt_valid),
        **{f: gather(getattr(sharded, f)) for f in _MEAS_FIELDS})


def _sigma_squared_global(local: BundleProblem, cam: atan.Camera,
                          cfg: BundleConfig, mest_kind: int, mesh: Mesh):
    """The robust sigma over every shard: one all_gather of the squared
    errors, -1 where a measurement does not count (the one O(M)
    collective), and the masked median of them all."""
    active = local.meas_valid & ~local.meas_bad
    _, _, _, err_sq, bad_proj = bundlelib._project_meas(
        local.cam_R, local.cam_t, local.pt_pos, local, cam)
    every = mesh.all_gather(torch.where(active & ~bad_proj, err_sq, -1.0))
    return mest.find_sigma_squared(torch.clamp(every, min=0.0), every >= 0.0,
                                   mest_kind, min_sigma=cfg.min_sigma)


def sharded_lm_step_flags(state: LMState, mesh: Mesh, cam: atan.Camera,
                          cfg: BundleConfig = BundleConfig(),
                          mest_kind: int = mest.TUKEY):
    """One point-sharded LM step on this rank's shard, and its flags
    (``bundle.lm_step_flags``'s, equal on every rank)."""
    prob, lay = state.problem, state.layout
    bundlelib._check_float32_products(prob.pt_pos)
    if cfg.soff_tiles or cfg.u_chunks:
        cfg = dataclasses.replace(cfg, soff_tiles=0, u_chunks=0)
    C, Pl = prob.cam_R.shape[0], prob.pt_pos.shape[0]
    C6 = C * 6
    local = _localized(prob, mesh)
    active = prob.meas_valid & ~prob.meas_bad

    sigma_sq = _sigma_squared_global(local, cam, cfg, mest_kind, mesh)
    U, ea, V9, eb, W, err_local, new_bad, good = bundlelib._accumulators(
        local, lay, cam, sigma_sq, cfg, mest_kind)
    red = mesh.all_reduce(torch.cat([U.reshape(-1), ea.reshape(-1),
                                     err_local.reshape(1)]))
    U = red[:36 * C].reshape(C, 6, 6)
    ea = red[36 * C:42 * C].reshape(C, 6)
    current_error = red[42 * C]
    W2d = W[0, :18 * C]                                   # (18C, Pl)
    W_m = W2d.reshape(C6, 3 * Pl)
    ebT = eb.T                                            # (3, Pl)
    camsys = bundlelib._camera_system(prob)

    def try_lambda(lam):
        Vi = bundlelib._vinv_cols(V9, lam)                # (3, 3, Pl)
        WV = bundlelib._wv_product(W2d, Vi, C6, Pl)
        part = mesh.all_reduce(torch.cat([(WV @ W_m.T).reshape(-1),
                                          WV @ ebT.reshape(-1)]))
        delta_cam = bundlelib._solve_cameras(
            camsys, part[:C6 * C6], part[C6 * C6:], U, ea, lam)
        corr = (delta_cam.reshape(-1) @ W_m).reshape(3, Pl)
        delta_pt = bundlelib._back_substitute(Vi, ebT - corr, prob.pt_valid)
        new_R, new_t, new_pt, nerr_local = bundlelib._trial(
            local, delta_cam, delta_pt, cam, sigma_sq, mest_kind, good,
            new_bad, active)
        sums = mesh.all_reduce(torch.stack([torch.sum(delta_pt ** 2),
                                            nerr_local]))
        upd_sq = torch.sum(delta_cam ** 2) + sums[0]
        return new_R, new_t, new_pt, upd_sq, sums[1]

    return bundlelib._retry_and_accept(state, cfg, try_lambda, current_error,
                                       new_bad)


def make_sharded_lm_step(mesh: Mesh, cam: atan.Camera,
                         cfg: BundleConfig = BundleConfig(),
                         mest_kind: int = mest.TUKEY):
    """A point-sharded LM step: LMState of a shard -> LMState."""
    def step(state: LMState) -> LMState:
        return sharded_lm_step_flags(state, mesh, cam, cfg, mest_kind)[0]
    return step


def sharded_lm_chunk(state: LMState, mesh: Mesh, cam: atan.Camera,
                     cfg: BundleConfig, mest_kind: int, iter_limit: int, f):
    """Sharded steps until converged, failed or ``iter_limit`` inner
    iterations (``bundle.lm_chunk``'s contract; the JAX package's
    ``cached_sharded_lm_chunk``). ``f`` is the state's flags. Returns
    (state, flags), equal on every rank."""
    while True:
        conv, iters, failed, _ = f
        if conv or failed or iters >= iter_limit:
            return state, f
        state, f = sharded_lm_step_flags(state, mesh, cam, cfg, mest_kind)


def save_sharded_state(path: str, state: LMState, mesh: Mesh) -> None:
    """Checkpoint a sharded run: the whole shard-ordered problem and the
    LM scalars (``io/checkpoint.save_ba_state``'s schema), written by the
    mesh's rank 0; every rank returns once it is on disk."""
    from ptam_cg_tpu_torch.io.checkpoint import save_ba_state
    whole = gather_sharded_problem(state.problem, mesh)
    if mesh.rank == 0:
        save_ba_state(path, dataclasses.replace(state, problem=whole))
    mesh.barrier()


def compute_sharded(problem: BundleProblem, mesh: Mesh, cam: atan.Camera,
                    cfg: BundleConfig = BundleConfig(),
                    mest_kind: int = mest.TUKEY, abort_check=None,
                    checkpoint_path: str | None = None,
                    checkpoint_every: int = 5, steps_per_dispatch: int = 5,
                    _initial_state: LMState | None = None,
                    return_flags: bool = False):
    """Distributed Bundle::Compute: sharded LM chunks of
    ``steps_per_dispatch`` iterations on every rank of ``mesh``.

    Returns (state, n_chunks) as ``bundle.compute`` does, on every rank,
    the problem put back in the input's measurement order (padding
    dropped) with the adjusted cameras and all points; its ``layout`` is
    None (the state is not stepped further). ``checkpoint_path``: the
    state goes to disk every ``checkpoint_every`` chunks and at the end
    (``save_sharded_state``); ``resume_sharded`` restarts it on any mesh
    whose size divides the point capacity. ``abort_check`` is polled
    between chunks on every rank; any rank's True stops them all. With
    ``return_flags=True`` also the last (converged, iters, failed,
    accepted)."""
    if _initial_state is None:
        original = problem
        shard, perm = shard_problem(problem, mesh, return_perm=True)
        state = init_sharded_lm(shard, mesh, cfg)
        f = bundlelib.INIT_FLAGS
    else:
        original = _initial_state.problem
        shard, perm = shard_problem(original, mesh, return_perm=True)
        state = dataclasses.replace(
            init_sharded_lm(shard, mesh, cfg),
            **{k: getattr(_initial_state, k) for k in (
                "lam", "lam_factor", "converged", "accepted", "iters",
                "last_error", "failed")})
        f = bundlelib.flags(state)
    n = 0
    conv, iters, failed, accepted = f
    while iters < cfg.max_iterations:
        state, f = sharded_lm_chunk(
            state, mesh, cam, cfg, mest_kind,
            min(iters + steps_per_dispatch, cfg.max_iterations), f)
        conv, iters, failed, accepted = f
        n += 1
        if conv or failed:
            break
        if checkpoint_path is not None and n % checkpoint_every == 0:
            save_sharded_state(checkpoint_path, state, mesh)
        if abort_check is not None and mesh.agree(bool(abort_check()),
                                                  dist.ReduceOp.MAX):
            break
    if checkpoint_path is not None:
        save_sharded_state(checkpoint_path, state, mesh)
    state = dataclasses.replace(
        state, problem=unshard_measurements(original, state.problem, perm,
                                            mesh), layout=None)
    if return_flags:
        return state, n, (bool(conv), iters, bool(failed), accepted)
    return state, n


def resume_sharded(checkpoint_path: str, mesh: Mesh, cam: atan.Camera,
                   cfg: BundleConfig = BundleConfig(),
                   mest_kind: int = mest.TUKEY,
                   abort_check=None) -> Tuple[LMState, int]:
    """Restart a checkpointed global BA on ``mesh``, whose size may differ
    from the run that wrote it (elastic recovery): ``meas_pt`` is global,
    so the checkpoint's problem re-shards onto any divisor mesh. A JAX
    package checkpoint loads the same way. The result's measurements are
    in the checkpoint's order."""
    from ptam_cg_tpu_torch.io.checkpoint import load_ba_state
    state = load_ba_state(checkpoint_path, device=mesh.device)
    return compute_sharded(state.problem, mesh, cam, cfg, mest_kind,
                           abort_check=abort_check,
                           checkpoint_path=checkpoint_path,
                           _initial_state=state)
