"""SO3/SE3 Lie-group operations on tensors (port of ``ptam_cg_tpu.utils.se3``).

Same conventions as the JAX package (TooN's): a pose maps world ->
camera, ``x_out = R @ x + t``; a twist is ``[u(3), w(3)]`` with the
translation part first. Everything is float32 and broadcasts over
leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

_EPS = 1e-8


@dataclasses.dataclass
class SE3:
    """Rigid transform: x_out = R @ x + t."""

    R: Tensor  # (..., 3, 3)
    t: Tensor  # (..., 3)


def identity(device, batch_shape=()) -> SE3:
    R = torch.eye(3, dtype=torch.float32, device=device).expand(
        *batch_shape, 3, 3).clone()
    return SE3(R, torch.zeros(*batch_shape, 3, dtype=torch.float32,
                              device=device))


def hat(w: Tensor) -> Tensor:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta_sq: Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with the JAX package's
    Taylor fallback below theta^2 < 1e-4 (see its docstring for why the
    threshold must cover the whole f32 cancellation zone)."""
    small = theta_sq < 1e-4
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, sin_t / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - sin_t) / (safe_sq * theta))
    return A, B, C


def _eye_like(K: Tensor) -> Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues: rotation 3-vector -> (..., 3, 3) rotation matrix."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    return _eye_like(K) + A[..., None, None] * K + B[..., None, None] * KK


def so2_exp(theta: Tensor) -> Tensor:
    """Angle -> (2, 2) rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def so3_log(R: Tensor) -> Tensor:
    """Rotation matrix -> rotation vector, theta in [0, pi]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1) * 0.5
    sin_t = torch.linalg.vector_norm(v, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    near_pi = theta > torch.pi - 1e-3
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(sin_t < _EPS,
                                            torch.ones_like(sin_t), sin_t))
    w_generic = scale[..., None] * v
    # Near pi: axis from the diagonal of (R + I) / 2, signs from the
    # symmetric off-diagonal part relative to the largest component.
    axis_sq = torch.stack([R[..., 0, 0] + 1.0, R[..., 1, 1] + 1.0,
                           R[..., 2, 2] + 1.0], dim=-1) / 2.0
    axis_abs = torch.sqrt(torch.clamp(axis_sq, min=0.0))
    sym = torch.stack([
        R[..., 2, 1] + R[..., 1, 2],   # a_y a_z term
        R[..., 0, 2] + R[..., 2, 0],   # a_x a_z
        R[..., 1, 0] + R[..., 0, 1],   # a_x a_y
    ], dim=-1)
    k = torch.argmax(axis_abs, dim=-1)

    def pair(i, j):
        return sym[..., 3 - i - j]

    prods = torch.stack([
        torch.where(k == 0, axis_sq[..., 0] * 2.0,
                    torch.where(k == 1, pair(0, 1), pair(0, 2))),
        torch.where(k == 1, axis_sq[..., 1] * 2.0,
                    torch.where(k == 0, pair(0, 1), pair(1, 2))),
        torch.where(k == 2, axis_sq[..., 2] * 2.0,
                    torch.where(k == 0, pair(0, 2), pair(1, 2))),
    ], dim=-1)
    axis_pi = torch.sign(prods) * axis_abs
    norm = torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.where(norm < _EPS, torch.ones_like(norm), norm)
    w_pi = axis_pi * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: Tensor) -> SE3:
    """Twist [u(3), w(3)] -> SE3, t = V(w) @ u."""
    u, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    eye = _eye_like(K)
    R = eye + A[..., None, None] * K + B[..., None, None] * KK
    V = eye + B[..., None, None] * K + C[..., None, None] * KK
    return SE3(R, (V @ u[..., None])[..., 0])


def se3_log(T: SE3) -> Tensor:
    """SE3 -> twist [u, w] (series form of V^-1 below theta^2 < 0.1, as
    the JAX package does, to avoid f32 cancellation)."""
    w = so3_log(T.R)
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    small = theta_sq < 0.1
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_b = torch.where(torch.abs(B) < 1e-12, torch.ones_like(B), B)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
        (1.0 - A / (2.0 * safe_b)) / safe_sq)
    Vinv = _eye_like(K) - 0.5 * K + coef[..., None, None] * KK
    u = (Vinv @ T.t[..., None])[..., 0]
    return torch.cat([u, w], dim=-1)


def mul(a: SE3, b: SE3) -> SE3:
    """Compose: (a*b)(x) = a(b(x))."""
    return SE3(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def inv(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -(Rt @ T.t[..., None])[..., 0])


def apply(T: SE3, x: Tensor) -> Tensor:
    """Transform points x (..., 3)."""
    return (T.R @ x[..., None])[..., 0] + T.t


def generator_field(i: int, p: Tensor) -> Tensor:
    """TooN's SE3::generator_field on homogeneous 4-vectors ``p`` (..., 4):
    generator ``i`` (0-2 translation, 3-5 rotation about axis i - 3)
    applied to each, with a zero w-component (include/Tracker.h:125-136,
    src/Bundle.cc:296-307)."""
    out = torch.zeros_like(p)
    if i < 3:
        out[..., i] = p[..., 3]
        return out
    j = i - 3
    a, b = (j + 1) % 3, (j + 2) % 3
    out[..., a] = -p[..., b]
    out[..., b] = p[..., a]
    return out


def motion_jacobian(p_cam: Tensor) -> Tensor:
    """(..., 6, 3): d p_cam / d xi for each SE3 generator (left update
    ``exp(xi) * T``)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows = [
        torch.stack([ones, zeros, zeros], dim=-1),
        torch.stack([zeros, ones, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_from_rot(R: Tensor) -> Tensor:
    """Rotation matrix -> quaternion [w, x, y, z] (Shepperd's method, the
    branch by the largest diagonal term), with w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([torch.stack(b, dim=-1) for b in (
        (1.0 + tr, m21 - m12, m02 - m20, m10 - m01),
        (m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20),
        (m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21),
        (m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11))], dim=-2)
    qs = qs / torch.linalg.vector_norm(qs, dim=-1, keepdim=True)
    case = torch.where(tr > 0.0, 0, torch.where(
        (m00 > m11) & (m00 > m22), 1, torch.where(m11 > m22, 2, 3)))
    q = torch.take_along_dim(qs, case[..., None, None].expand(
        *case.shape, 1, 4), dim=-2)[..., 0, :]
    return torch.where(q[..., :1] < 0, -q, q)


def rot_from_quat(q: Tensor) -> Tensor:
    """Quaternion [w, x, y, z] (any norm) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def euler_from_rot(R: Tensor) -> Tensor:
    """Rotation matrix -> XYZ Euler angles [roll, pitch, yaw]; near the
    singular pitch (cos pitch < 1e-6) yaw is 0 and roll takes the rest."""
    R = torch.as_tensor(R, dtype=torch.float32)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                       torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, torch.zeros_like(sy),
                      torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rot_from_euler(rpy: Tensor) -> Tensor:
    """XYZ Euler angles [roll, pitch, yaw] -> rotation matrix Rz Ry Rx."""
    rpy = torch.as_tensor(rpy, dtype=torch.float32)
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr,
                     cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr,
                     sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def lh_from_rh(T: SE3) -> SE3:
    """Right-handed -> left-handed coordinates (cg::Tools::LHFromRH,
    src/Tools.cc:6-21): conjugation by diag(1, 1, -1), which negates
    R[2, 0:2], R[0:2, 2] and t[2]. Its own inverse; broadcasts over
    batched poses."""
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32,
                        device=T.R.device)
    return SE3(T.R * flip[:, None] * flip[None, :], T.t * flip)
