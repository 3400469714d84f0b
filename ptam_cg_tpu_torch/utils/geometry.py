"""Small geometry solvers (port of ``ptam_cg_tpu.utils.geometry``):
``spd_solve`` and DLT ``triangulate``. All in float32.

The DLT null space is the eigenvector of AᵀA for its smallest eigenvalue,
as in the JAX package, but from a cyclic Jacobi eigen-solve of a fixed
number of sweeps written in tensor ops, not ``torch.linalg.eigh``: on a
CUDA device that batches cuSOLVER's Jacobi solver, which raises when it
misses its tolerance (it did for keyframes with no baseline between
them), and checks for that with a host sync.
"""

from __future__ import annotations

import functools

import torch

from ptam_cg_tpu_torch.utils.se3 import SE3

Tensor = torch.Tensor


def spd_solve(A: Tensor, b: Tensor) -> Tensor:
    """Solve A x = b for small SPD A (..., n, n) by an unrolled Cholesky,
    the same elementwise sequence as the JAX package (n <= 9)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


#: Cyclic Jacobi on 4x4: each round rotates two disjoint pairs, three
#: rounds visit all six pairs once. Convergence is quadratic: four sweeps
#: reach float32 rounding on random matrices and on the DLT systems of
#: the keyframe path (a fifth changes no result; three do not suffice).
_JACOBI_ROUNDS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))
JACOBI_SWEEPS = 4


def _rotation_basis(p, q, r, s, device) -> Tensor:
    """(4, 4, 4) matrices B such that the Jacobi rotation of the pairs
    (p, q) and (r, s) is I + sum_k coef_k B_k, coef = (c1 - 1, s1, c2 - 1,
    s2)."""
    B = torch.zeros((4, 4, 4), dtype=torch.float32, device=device)
    for k, (i, j) in enumerate(((p, q), (r, s))):
        B[2 * k, i, i] = B[2 * k, j, j] = 1.0
        B[2 * k + 1, i, j] = 1.0
        B[2 * k + 1, j, i] = -1.0
    return B


@functools.lru_cache(maxsize=None)
def _jacobi_rounds(device):
    """Per round: the (rows, cols) that gather (app, aqq, apq) of both
    pairs, and the rotation basis. Made once per device: a host-to-device
    copy waits for the device."""
    return [(torch.tensor([p, r, q, s, p, r], device=device),
             torch.tensor([p, r, q, s, q, s], device=device),
             _rotation_basis(p, q, r, s, device))
            for p, q, r, s in _JACOBI_ROUNDS]


def sym4_eigh(M: Tensor):
    """Eigen-decomposition of symmetric (..., 4, 4) float32 matrices by
    cyclic Jacobi (Golub and Van Loan, Alg. 8.4.3). Returns (eigenvalues
    (..., 4), eigenvectors as columns (..., 4, 4)), in no set order."""
    eye = torch.eye(4, dtype=M.dtype, device=M.device)
    V = eye.expand(M.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        for rows, cols, basis in _jacobi_rounds(M.device):
            v = M[..., rows, cols]
            app, aqq, apq = v[..., 0:2], v[..., 2:4], v[..., 4:6]
            zero = apq == 0.0
            tau = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            sgn = torch.where(tau >= 0.0, 1.0, -1.0)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            coef = torch.stack([c - 1.0, t * c], -1).flatten(-2)
            J = eye + torch.tensordot(coef, basis, dims=1)
            M = J.transpose(-1, -2) @ M @ J
            V = V @ J
    return torch.diagonal(M, dim1=-2, dim2=-1), V


def _smallest_right_singular(A: Tensor) -> Tensor:
    """Right-singular vector of (..., m, 4) for its smallest singular
    value: the eigenvector of AᵀA with the smallest eigenvalue."""
    vals, vecs = sym4_eigh(A.transpose(-1, -2) @ A)
    k = torch.argmin(vals, dim=-1)
    return torch.gather(vecs, -1, k[..., None, None].expand(
        *vecs.shape[:-1], 1))[..., 0]


def triangulate(se3_a_from_b: SE3, v2a: Tensor, v2b: Tensor) -> Tensor:
    """DLT triangulation in frame B from two z=1-plane observations
    (MapMaker::Triangulate); broadcasts over leading dims."""
    R, t = se3_a_from_b.R, se3_a_from_b.t
    PDash = torch.cat([R, t[..., :, None]], dim=-1)          # (..., 3, 4)
    xa, ya = v2a[..., 0], v2a[..., 1]
    xb, yb = v2b[..., 0], v2b[..., 1]
    zeros = torch.zeros_like(xb)
    ones = torch.ones_like(xb)
    row0 = torch.stack([-ones, zeros, xb, zeros], dim=-1)
    row1 = torch.stack([zeros, -ones, yb, zeros], dim=-1)
    row2 = xa[..., None] * PDash[..., 2, :] - PDash[..., 0, :]
    row3 = ya[..., None] * PDash[..., 2, :] - PDash[..., 1, :]
    A = torch.stack([row0, row1, row2, row3], dim=-2)
    v4 = _smallest_right_singular(A)
    w = v4[..., 3]
    w = torch.where(torch.abs(w) < 1e-5, torch.where(w < 0, -1e-5, 1e-5), w)
    return v4[..., :3] / w[..., None]
