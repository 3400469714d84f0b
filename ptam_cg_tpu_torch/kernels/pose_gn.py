"""K4: the tracker's robust Gauss-Newton pose loop (``csrc/pose_gn.cu``).

Replaces the JAX package's ``lax.while_loop`` in
``ptam_cg_tpu/models/tracker.py::_gn_pose_iterations`` (:321-375), which
``track_map`` runs twice a frame: over the coarse subset (N = 128,
``tracker.COARSE_CAP``) and over coarse + fine (N = 1152,
``tracker.TRACK_CAP``). The JAX package shaped it for the TPU (an
approximate median because a full sort an iteration dominated there);
the kernel computes the same function, that median included, in one
block for the whole loop (see the note in the source).

``pose_gn`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises. ``pose_gn_plain`` is the port's loop
as it was: ``n_iters`` iterations with the pose and the weights frozen
once the JAX loop would have exited. The kernel exits there instead;
both give the same result. Only the sums (``J^T W J``, ``J^T W e``, the
LSQ numerator) and the 6x6 algebra round otherwise than the plain
version: per-point arithmetic is separately rounded in its order.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ptam_cg_tpu_torch.camera import atan
from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.ops import levels as levelops
from ptam_cg_tpu_torch.utils import mest
from ptam_cg_tpu_torch.utils import se3 as se3lib
from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor

#: The most points one launch takes (the source's MAX_N: 512 threads, 3
#: points each).
MAX_N = 1536

#: Kernel launches made by ``pose_gn`` in this process.
launches = 0
#: The same launches by CUDA stream (raw handle; 0 is the legacy default
#: stream), counted with ``launches`` by ``_build.count_launch``.
launches_by_stream: dict = {}

#: The camera fields the kernel reads, in the C entry's order.
CAM_FIELDS = ("focal", "center", "two_tan", "winv", "distortion_enabled",
              "largest_radius", "max_r")


def pose_gn_plain(pose: SE3, cam: atan.Camera, image_size, pts_w: Tensor,
                  found: Tensor, v2found: Tensor, level: Tensor, n_iters: int,
                  override_after: int, override_val: float,
                  mest_kind: int = mest.TUKEY):
    """Plain version of ``pose_gn``: the Tukey-reweighted Gauss-Newton
    pose loop. Runs ``n_iters`` iterations; once the JAX loop would have
    exited (in the override-sigma regime with a ~zero update) the pose
    and weights stay frozen. Returns (pose, final weights)."""
    sqrt_inv_noise = 1.0 / levelops.level_scale(level)
    dev = pts_w.device
    eye6 = 100.0 * torch.eye(6, dtype=torch.float32, device=dev)
    R, t = pose.R, pose.t
    w = torch.zeros(pts_w.shape[0], dtype=torch.float32, device=dev)
    settled = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(n_iters):
        pose_i = SE3(R, t)
        p_cam, z1, pix, proj_ok = atan.project_points(pose_i, pts_w, cam,
                                                      image_size)
        J = atan.pose_jacobian(p_cam, atan.project_derivs(z1, cam))
        err = (v2found - pix) * sqrt_inv_noise[:, None]
        ok = found & proj_ok
        err_sq = torch.sum(err * err, dim=-1)
        if it > override_after:
            sigma_sq = torch.full((), override_val, dtype=torch.float32,
                                  device=dev)
        else:
            sigma_sq = mest.find_sigma_squared(err_sq, ok, mest_kind,
                                               approx=True)
        w_i = torch.where(ok, mest.weight(err_sq, sigma_sq, mest_kind), 0.0)
        Js = J * sqrt_inv_noise[:, None, None]
        JTJ = torch.einsum("n,nij,nik->jk", w_i, Js, Js) + eye6
        rhs = torch.einsum("n,nij,ni->j", w_i, Js, err)
        upd = torch.linalg.solve_ex(JTJ, rhs).result
        new = se3lib.mul(se3lib.se3_exp(upd), pose_i)
        R = torch.where(settled, R, new.R)
        t = torch.where(settled, t, new.t)
        w = torch.where(settled, w, w_i)
        if it > override_after:
            settled = settled | (torch.sum(upd * upd) < 1e-10)
    return SE3(R, t), w


def _expect(x: Tensor, what: str, shape, dtype, device) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype or \
            x.device != device or not x.is_contiguous():
        raise ValueError(f"pose_gn: {what} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}"
                         f"{'' if x.is_contiguous() else ', strided'}")


def validate(pose: SE3, cam: atan.Camera, pts_w: Tensor, found: Tensor,
             v2found: Tensor, level: Tensor, n_iters: int,
             mest_kind: int) -> None:
    """Raise ValueError on what the kernel cannot take: N outside 1 ..
    ``MAX_N``, a dtype or shape other than the C entry's, a strided
    tensor, tensors on several devices, an unknown estimator."""
    N = pts_w.shape[0] if pts_w.ndim == 2 else -1
    if not 1 <= N <= MAX_N:
        raise ValueError(f"pose_gn: the kernel takes 1 to {MAX_N} points "
                         f"in one block, got {tuple(pts_w.shape)}")
    dev = pts_w.device
    _expect(pts_w, "pts_w", (N, 3), torch.float32, dev)
    _expect(found, "found", (N,), torch.bool, dev)
    _expect(v2found, "v2found", (N, 2), torch.float32, dev)
    _expect(level, "level", (N,), torch.int64, dev)
    _expect(pose.R, "pose.R", (3, 3), torch.float32, dev)
    _expect(pose.t, "pose.t", (3,), torch.float32, dev)
    for f in CAM_FIELDS:
        x = getattr(cam, f)
        _expect(x, f"cam.{f}", (2,) if f in ("focal", "center") else (),
                torch.float32, dev)
    if mest_kind not in mest._SIGMA_SCALE or n_iters < 0:
        raise ValueError(f"pose_gn: estimator {mest_kind}, {n_iters} "
                         f"iterations")


def _lib():
    fn = _build.load("pose_gn").pose_gn
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_float]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def pose_gn(pose: SE3, cam: atan.Camera, image_size, pts_w: Tensor,
            found: Tensor, v2found: Tensor, level: Tensor, n_iters: int,
            override_after: int, override_val: float,
            mest_kind: int = mest.TUKEY):
    """The robust Gauss-Newton pose loop over N world points ``pts_w``
    (N, 3) float32 with their found flags (N,) bool, found level-0
    positions ``v2found`` (N, 2) float32 and search levels (N,) int64:
    ``n_iters`` iterations at most, sigma^2 from the errors until
    ``override_after`` then ``override_val``, weights of estimator
    ``mest_kind``. Returns (pose, final weights (N,))."""
    if pts_w.device.type == "cpu":
        return pose_gn_plain(pose, cam, image_size, pts_w, found, v2found,
                             level, n_iters, override_after, override_val,
                             mest_kind)
    validate(pose, cam, pts_w, found, v2found, level, n_iters, mest_kind)
    if pts_w.device.type != "cuda":
        raise ValueError(f"pose_gn: need CUDA tensors, got {pts_w.device}")
    N = pts_w.shape[0]
    W, H = image_size
    R_out = torch.empty((3, 3), dtype=torch.float32, device=pts_w.device)
    t_out = torch.empty(3, dtype=torch.float32, device=pts_w.device)
    w_out = torch.empty(N, dtype=torch.float32, device=pts_w.device)
    fn = _lib()
    stream = _build.stream_handle(pts_w)
    _build.count_launch(sys.modules[__name__], stream)
    _build.check(fn(pose.R.data_ptr(), pose.t.data_ptr(), pts_w.data_ptr(),
                    found.data_ptr(), v2found.data_ptr(), level.data_ptr(),
                    *(getattr(cam, f).data_ptr() for f in CAM_FIELDS),
                    N, int(W), int(H), int(n_iters), int(override_after),
                    float(override_val), int(mest_kind),
                    float(mest._SIGMA_SCALE[mest_kind]), R_out.data_ptr(),
                    t_out.data_ptr(), w_out.data_ptr(), stream), "pose_gn")
    return SE3(R_out, t_out), w_out
