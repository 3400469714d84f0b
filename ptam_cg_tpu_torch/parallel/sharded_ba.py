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

The JAX package runs a chunk of sharded steps as one compiled program.
Here gloo's collectives stage through the host and cannot sit in a CUDA
graph, so ``ShardedPrograms`` holds the four stretches of a step between
its collectives, each a graph on the card (``compute_sharded``,
``resume_sharded`` and ``MapMaker(mesh=)`` replay them), and the
collectives run eagerly between the replays.
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
from ptam_cg_tpu_torch.models import graphs as graphlib
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


def _localized(prob: BundleProblem, rank: int) -> BundleProblem:
    """Rank ``rank``'s shard with ``meas_pt`` as an index into its own
    points."""
    Pl = prob.pt_pos.shape[0]
    return dataclasses.replace(prob, meas_pt=prob.meas_pt - rank * Pl)


def init_sharded_lm(shard: BundleProblem, mesh: Mesh,
                    cfg: BundleConfig = BundleConfig()) -> LMState:
    """The LM start state of a shard: ``bundle.init_lm`` with the
    measurement layout of the shard's own points (one host read)."""
    layout = bundlelib.measurement_layout(_localized(shard, mesh.rank))
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


def _sigma_inputs(prob: BundleProblem, rank: int,
                  cam: atan.Camera) -> Tensor:
    """Stretch 1 of a step: the shard's squared errors, -1 where a
    measurement does not count, for the robust sigma's all_gather (the
    one O(M) collective)."""
    local = _localized(prob, rank)
    active = local.meas_valid & ~local.meas_bad
    _, _, _, err_sq, bad_proj = bundlelib._project_meas(
        local.cam_R, local.cam_t, local.pt_pos, local, cam)
    return torch.where(active & ~bad_proj, err_sq, -1.0)


def _accumulate(prob: BundleProblem, lay: bundlelib.MeasLayout,
                every: Tensor, rank: int, cam: atan.Camera,
                cfg: BundleConfig, mest_kind: int):
    """Stretch 2: the robust sigma over every shard's squared errors
    (``every``, all gathered), the shard's accumulators, and U, ea and the
    shard's error packed for the step's all_reduce. Returns (packed,
    sigma_sq, V9, W, eb, new_bad, good, active)."""
    sigma_sq = mest.find_sigma_squared(torch.clamp(every, min=0.0),
                                       every >= 0.0, mest_kind,
                                       min_sigma=cfg.min_sigma)
    U, ea, V9, eb, W, err_local, new_bad, good = bundlelib._accumulators(
        _localized(prob, rank), lay, cam, sigma_sq, cfg, mest_kind)
    packed = torch.cat([U.reshape(-1), ea.reshape(-1),
                        err_local.reshape(1)])
    active = prob.meas_valid & ~prob.meas_bad
    return packed, sigma_sq, V9, W, eb, new_bad, good, active


def _schur_part(V9: Tensor, W: Tensor, eb: Tensor, lam: Tensor):
    """Stretch 3, a lambda try up to its all_reduce: V*^-1 and the shard's
    S_off = W V*^-1 W^T partial and rhs correction, packed. Returns (Vi,
    packed)."""
    Pl = V9.shape[0]
    C6 = 6 * (W.shape[1] // 18 - 1)         # W's last 18 rows: the dump
    W2d = W[0, :3 * C6]                                   # (18C, Pl)
    Vi = bundlelib._vinv_cols(V9, lam)                    # (3, 3, Pl)
    WV = bundlelib._wv_product(W2d, Vi, C6, Pl)
    W_m = W2d.reshape(C6, 3 * Pl)
    return Vi, torch.cat([(WV @ W_m.T).reshape(-1),
                          WV @ eb.T.reshape(-1)])


def _trial_part(prob: BundleProblem, rank: int, Vi: Tensor, W: Tensor,
                eb: Tensor, red: Tensor, part: Tensor, lam: Tensor,
                sigma_sq: Tensor, good: Tensor, new_bad: Tensor,
                active: Tensor, cam: atan.Camera, mest_kind: int):
    """Stretch 4, the rest of a try up to its all_reduce: the camera solve
    from the reduced sums (``red``: U, ea, error; ``part``: S_off, rhs),
    the shard's points back-substituted and the trial. Returns (new_R,
    new_t, new_pt, [point-update norm, trial error] of the shard, the
    camera-update norm)."""
    C = prob.cam_R.shape[0]
    Pl = prob.pt_pos.shape[0]
    C6 = C * 6
    U = red[:36 * C].reshape(C, 6, 6)
    ea = red[36 * C:42 * C].reshape(C, 6)
    delta_cam = bundlelib._solve_cameras(
        bundlelib._camera_system(prob), part[:C6 * C6], part[C6 * C6:], U,
        ea, lam)
    W_m = W[0, :18 * C].reshape(C6, 3 * Pl)
    corr = (delta_cam.reshape(-1) @ W_m).reshape(3, Pl)
    delta_pt = bundlelib._back_substitute(Vi, eb.T - corr, prob.pt_valid)
    new_R, new_t, new_pt, nerr_local = bundlelib._trial(
        _localized(prob, rank), delta_cam, delta_pt, cam, sigma_sq,
        mest_kind, good, new_bad, active)
    return (new_R, new_t, new_pt,
            torch.stack([torch.sum(delta_pt ** 2), nerr_local]),
            torch.sum(delta_cam ** 2))


def _plain_cfg(cfg: BundleConfig) -> BundleConfig:
    """``cfg`` with ``soff_tiles`` and ``u_chunks`` off: the shards divide
    the working set already."""
    if cfg.soff_tiles or cfg.u_chunks:
        cfg = dataclasses.replace(cfg, soff_tiles=0, u_chunks=0)
    return cfg


class ShardedPrograms:
    """A sharded LM step's four stretches between its collectives as
    ``graphs.Job``s (the JAX package's ``cached_sharded_lm_chunk`` is one
    compiled program; gloo's collectives stage through the host and cannot
    sit in a CUDA graph, so the stretches between them are captured and
    the collectives run eagerly between replays): the sigma inputs, the
    accumulators, a try's Schur partial and a try's solve and trial. Each
    works on static buffers: the shard's problem and measurement layout
    (filled from the state at each step, so a later run of the same key
    reads its own; a tensor that is already the buffer is not copied),
    and the collectives' results. A later stretch reads an
    earlier one's outputs, which stay until that stretch runs again.

    One set serves one shard shape, ``MeasLayout``, config, estimator and
    rank (``key_of``); its graphs are captured at their first calls. With
    ``graphs_on`` False, or on the CPU, the jobs run eagerly on the same
    buffers. Host reads: those of ``_retry_and_accept`` alone, a try's
    flags from the values the collectives bring back."""

    def __init__(self, state: LMState, mesh: Mesh, cam: atan.Camera,
                 cfg: BundleConfig, mest_kind: int, graphs_on: bool = True,
                 debug_dir: str | None = None):
        cfg = _plain_cfg(cfg)
        self.rank, self.cam, self.cfg, self.kind = mesh.rank, cam, cfg, \
            mest_kind
        self.key = self.key_of(state, mesh, cfg, mest_kind)
        prob, lay = state.problem, state.layout
        self.device = prob.pt_pos.device
        self.graphs = graphlib.on_card(self.device, graphs_on)
        self.debug_dir = debug_dir
        self.prob = BundleProblem(*(t.clone()
                                    for t in bundlelib._fields(prob)))
        self.lay = bundlelib.MeasLayout(
            lay.cam.clone(), lay.pt.clone(), lay.pt_rank.clone(),
            lay.pair_rank.clone(), lay.n_pt, lay.n_pair)
        C, M = prob.cam_R.shape[0], prob.meas_cam.shape[0]
        C6 = 6 * C

        def z(n):
            return torch.zeros(n, dtype=torch.float32, device=self.device)

        self.every, self.red = z(mesh.size * M), z(42 * C + 1)
        self.part, self.lam = z(C6 * C6 + C6), z(())
        self.jobs = {}
        #: (label, capture seconds) of each capture.
        self.captures = []

    @staticmethod
    def _lay_tensors(lay: bundlelib.MeasLayout) -> tuple:
        return (lay.cam, lay.pt, lay.pt_rank, lay.pair_rank)

    @staticmethod
    def key_of(state: LMState, mesh: Mesh, cfg: BundleConfig,
               mest_kind: int):
        p = state.problem
        return (p.cam_R.shape[0], p.pt_pos.shape[0], p.meas_cam.shape[0],
                state.layout.n_pt, state.layout.n_pair, _plain_cfg(cfg),
                mest_kind, mesh.rank, mesh.size)

    def _run(self, label: str, fn, inputs: tuple):
        job = self.jobs.get(label)
        if job is None:
            path = (None if self.debug_dir is None
                    else f"{self.debug_dir}/sharded_{label}.dot")
            job = self.jobs[label] = graphlib.Job(label, fn, inputs,
                                                self.device, self.graphs,
                                                path)
        capture = job.will_capture()
        out = job.run()
        if capture:
            self.captures.append((label, job.graph.capture_s))
        return out

    def sigma_inputs(self, state: LMState) -> Tensor:
        lay = state.layout
        for buf, x in zip(
                bundlelib._fields(self.prob) + self._lay_tensors(self.lay),
                bundlelib._fields(state.problem) + self._lay_tensors(lay)):
            graphlib.fill(buf, x)
        rank, cam = self.rank, self.cam
        return self._run("sigma", lambda prob: _sigma_inputs(prob, rank,
                                                             cam),
                         (self.prob,))

    def accumulate(self, every: Tensor):
        graphlib.fill(self.every, every)
        rank, cam, cfg, kind = self.rank, self.cam, self.cfg, self.kind
        self.acc = self._run(
            "accumulate", lambda prob, lay, ev: _accumulate(
                prob, lay, ev, rank, cam, cfg, kind),
            (self.prob, self.lay, self.every))
        return self.acc

    def schur(self, lam: Tensor):
        graphlib.fill(self.lam, lam)
        _, _, V9, W, eb = self.acc[:5]
        self.Vi, packed = self._run("schur", _schur_part,
                                    (V9, W, eb, self.lam))
        return packed

    def trial(self, red: Tensor, part: Tensor, lam: Tensor):
        graphlib.fill(self.red, red)
        graphlib.fill(self.part, part)
        graphlib.fill(self.lam, lam)
        _, sigma_sq, _, W, eb, new_bad, good, active = self.acc
        rank, cam, kind = self.rank, self.cam, self.kind
        return self._run(
            "trial", lambda prob, *a: _trial_part(prob, rank, *a, cam=cam,
                                                  mest_kind=kind),
            (self.prob, self.Vi, W, eb, self.red, self.part, self.lam,
             sigma_sq, good, new_bad, active))


def sharded_lm_step_flags(state: LMState, mesh: Mesh, cam: atan.Camera,
                          cfg: BundleConfig = BundleConfig(),
                          mest_kind: int = mest.TUKEY,
                          programs: ShardedPrograms | None = None):
    """One point-sharded LM step on this rank's shard, and its flags
    (``bundle.lm_step_flags``'s, equal on every rank). ``programs``: the
    stretches between the collectives (``ShardedPrograms`` of this
    state's key); without, eager ones are made for the step."""
    bundlelib._check_float32_products(state.problem.pt_pos)
    cfg = _plain_cfg(cfg)
    C = state.problem.cam_R.shape[0]
    run = programs or ShardedPrograms(state, mesh, cam, cfg, mest_kind,
                                      graphs_on=False)
    every = mesh.all_gather(run.sigma_inputs(state))
    red = mesh.all_reduce(run.accumulate(every)[0])
    new_bad = run.acc[5]

    def try_lambda(lam):
        part = mesh.all_reduce(run.schur(lam))
        new_R, new_t, new_pt, sums, upd_cam = run.trial(red, part, lam)
        sums = mesh.all_reduce(sums)
        return new_R, new_t, new_pt, upd_cam + sums[0], sums[1]

    return bundlelib._retry_and_accept(state, cfg, try_lambda, red[42 * C],
                                       new_bad)


def make_sharded_lm_step(mesh: Mesh, cam: atan.Camera,
                         cfg: BundleConfig = BundleConfig(),
                         mest_kind: int = mest.TUKEY):
    """A point-sharded LM step: LMState of a shard -> LMState."""
    def step(state: LMState) -> LMState:
        return sharded_lm_step_flags(state, mesh, cam, cfg, mest_kind)[0]
    return step


def sharded_lm_chunk(state: LMState, mesh: Mesh, cam: atan.Camera,
                     cfg: BundleConfig, mest_kind: int, iter_limit: int, f,
                     programs: ShardedPrograms | None = None):
    """Sharded steps until converged, failed or ``iter_limit`` inner
    iterations (``bundle.lm_chunk``'s contract; the JAX package's
    ``cached_sharded_lm_chunk``). ``f`` is the state's flags;
    ``programs``: ``sharded_lm_step_flags``'s. Returns (state, flags),
    equal on every rank."""
    while True:
        conv, iters, failed, _ = f
        if conv or failed or iters >= iter_limit:
            return state, f
        state, f = sharded_lm_step_flags(state, mesh, cam, cfg, mest_kind,
                                         programs)


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
                    return_flags: bool = False, graphs: bool = True):
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
    accepted). ``graphs``: on the card, the steps' stretches between
    collectives replay as CUDA graphs (``ShardedPrograms``, captured in
    this call); False runs them eagerly, as the CPU does."""
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
    progs = ShardedPrograms(state, mesh, cam, cfg, mest_kind, graphs)
    n = 0
    conv, iters, failed, accepted = f
    while iters < cfg.max_iterations:
        state, f = sharded_lm_chunk(
            state, mesh, cam, cfg, mest_kind,
            min(iters + steps_per_dispatch, cfg.max_iterations), f, progs)
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
                   mest_kind: int = mest.TUKEY, abort_check=None,
                   graphs: bool = True) -> Tuple[LMState, int]:
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
                           _initial_state=state, graphs=graphs)
