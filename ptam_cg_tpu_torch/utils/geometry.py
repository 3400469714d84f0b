"""Small geometry solvers (port of ``ptam_cg_tpu.utils.geometry``):
``spd_solve``, the DLT triangulations (``triangulate``,
``triangulate_new``, ``triangulate_depths``), the rigid alignments
(``umeyama_icp``, ``horn_icp``), ``sampson_error``, and the small
symmetric eigen-solver ``sym_eigh`` with what is built on it
(``smallest_eigvec``, ``svd3``, ``det3``). All in float32.

The DLT null space is the eigenvector of AᵀA for its smallest eigenvalue,
as in the JAX package, but from a cyclic Jacobi eigen-solve of a fixed
number of sweeps written in tensor ops, not ``torch.linalg.eigh``: on a
CUDA device that batches cuSOLVER's Jacobi solver, which raises when it
misses its tolerance (it did for keyframes with no baseline between
them), and checks for that with a host sync. ``torch.linalg.svd`` checks
for errors with a host sync too, so the 3x3 SVD is built on the same
solver.
"""

from __future__ import annotations

import functools

import torch

from ptam_cg_tpu_torch.utils import se3 as se3lib
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
#: rounds visit all six pairs once.
_JACOBI_ROUNDS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))
#: Sweeps of ``sym_eigh`` by size. Convergence is quadratic: four sweeps
#: reach float32 rounding on the 4x4 DLT systems of ``triangulate`` and on
#: random matrices (a fifth changes no result; three do not suffice);
#: for the 3x3 covariances and SVDs and the 9x9 DLT normal matrices of the
#: homography, one more sweep changes no result
#: (tests/test_torch_homography.py checks it).
EIGH_SWEEPS = {3: 5, 4: 4, 9: 9}


def _round_robin(n: int):
    """Rounds of disjoint index pairs that visit every pair of 0..n-1 once
    (the circle method): n-1 rounds of n/2 pairs, or for odd n, n rounds
    of (n-1)/2 pairs with one index idle."""
    if n == 4:
        return tuple(((p, q), (r, s)) for p, q, r, s in _JACOBI_ROUNDS)
    m = n + n % 2
    idx = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [(min(idx[i], idx[m - 1 - i]), max(idx[i], idx[m - 1 - i]))
                 for i in range(m // 2)]
        rounds.append(tuple(pq for pq in pairs if pq[1] < n))
        idx = [idx[0], idx[-1]] + idx[1:-1]
    return tuple(rounds)


def _rotation_basis(pairs, n, device) -> Tensor:
    """(2k, n, n) matrices B such that the Jacobi rotation of the k
    disjoint ``pairs`` is I + sum_j coef_j B_j, coef = (c1 - 1, s1, c2 - 1,
    s2, ...)."""
    B = torch.zeros((2 * len(pairs), n, n), dtype=torch.float32,
                    device=device)
    for k, (i, j) in enumerate(pairs):
        B[2 * k, i, i] = B[2 * k, j, j] = 1.0
        B[2 * k + 1, i, j] = 1.0
        B[2 * k + 1, j, i] = -1.0
    return B


@functools.lru_cache(maxsize=None)
def _jacobi_rounds(n: int, device):
    """Per round: the (rows, cols) that gather (app, aqq, apq) of its
    pairs, and the rotation basis. Made once per size and device: a
    host-to-device copy waits for the device."""
    out = []
    for pairs in _round_robin(n):
        ps = [p for p, _ in pairs]
        qs = [q for _, q in pairs]
        out.append((torch.tensor(ps + qs + ps, device=device),
                    torch.tensor(ps + qs + qs, device=device),
                    _rotation_basis(pairs, n, device)))
    return out


def sym_eigh(M: Tensor):
    """Eigen-decomposition of symmetric (..., n, n) float32 matrices by
    cyclic Jacobi over rounds of disjoint pairs (Golub and Van Loan, Alg.
    8.4.3), ``EIGH_SWEEPS[n]`` sweeps: no data-dependent exit, so nothing
    is read on the host and nothing can raise. Returns (eigenvalues
    (..., n), eigenvectors as columns (..., n, n)), in no set order."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    V = eye.expand(M.shape).clone()
    for _ in range(EIGH_SWEEPS[n]):
        for rows, cols, basis in _jacobi_rounds(n, M.device):
            k = basis.shape[0] // 2
            v = M[..., rows, cols]
            app, aqq, apq = v[..., :k], v[..., k:2 * k], v[..., 2 * k:]
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


def smallest_eigvec(M: Tensor) -> Tensor:
    """Eigenvector (..., n) of symmetric (..., n, n) for its smallest
    eigenvalue (the first one on a tie), its largest-magnitude entry made
    positive."""
    vals, vecs = sym_eigh(M)
    k = torch.argmin(vals, dim=-1)
    v = torch.gather(vecs, -1, k[..., None, None].expand(
        *vecs.shape[:-1], 1))[..., 0]
    return _canonical_sign(v)


def _canonical_sign(v: Tensor) -> Tensor:
    """Vectors (..., n) with the sign that makes the entry of largest
    magnitude (the first one on a tie) positive."""
    i = torch.argmax(torch.abs(v), dim=-1, keepdim=True)
    return torch.where(torch.gather(v, -1, i) < 0.0, -v, v)


def det3(m: Tensor) -> Tensor:
    """Closed-form determinant of (..., 3, 3) matrices."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def svd3(H: Tensor):
    """SVD of (..., 3, 3) float32 matrices: (U, singular values in
    descending order, V), with H = U diag(s) V^T. V comes from the
    eigenvectors of H^T H, each column's largest-magnitude entry made
    positive, so the card and the CPU give the same signs; U's first two
    columns are H v / s (the second made orthogonal to the first), its
    third their cross product, signed as H v3. Nothing syncs or raises
    (``torch.linalg.svd`` checks for errors with a host read)."""
    vals, vecs = sym_eigh(H.transpose(-1, -2) @ H)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    vals = torch.gather(vals, -1, order)
    V = torch.gather(vecs, -1, order[..., None, :].expand(vecs.shape))
    V = _canonical_sign(V.transpose(-1, -2)).transpose(-1, -2)
    s = torch.sqrt(torch.clamp(vals, min=0.0))
    HV = H @ V

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True),
                               min=1e-30)

    u1 = unit(HV[..., 0])
    u2 = HV[..., 1]
    u2 = unit(u2 - u1 * torch.sum(u1 * u2, dim=-1, keepdim=True))
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    u3 = torch.where(torch.sum(u3 * HV[..., 2], dim=-1, keepdim=True) < 0.0,
                     -u3, u3)
    return torch.stack([u1, u2, u3], dim=-1), s, V


def _smallest_right_singular(A: Tensor) -> Tensor:
    """Right-singular vector of (..., m, 4) for its smallest singular
    value: the eigenvector of AᵀA with the smallest eigenvalue."""
    vals, vecs = sym_eigh(A.transpose(-1, -2) @ A)
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


def _cross_matrix(v3: Tensor) -> Tensor:
    """Skew-symmetric cross-product matrices, (..., 3) -> (..., 3, 3)."""
    x, y, z = v3[..., 0], v3[..., 1], v3[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def triangulate_new(se3_a_from_b: SE3, v2a: Tensor, v2b: Tensor) -> Tensor:
    """Cross-product DLT triangulation (MapMaker::TriangulateNew,
    src/MapMaker.cc:216-258): the null space of [v3a]x P_A stacked over
    [v3b]x [I | 0], a 6x4 system. The point in frame B; broadcasts over
    leading dims."""
    R, t = se3_a_from_b.R, se3_a_from_b.t
    one = torch.ones_like(v2a[..., :1])
    v3a = torch.cat([v2a, one], dim=-1)
    v3b = torch.cat([v2b, one], dim=-1)
    PA = torch.cat([R, t[..., :, None]], dim=-1)            # (..., 3, 4)
    eye34 = torch.eye(3, 4, dtype=v2a.dtype, device=v2a.device)
    A = torch.cat([_cross_matrix(v3a) @ PA, _cross_matrix(v3b) @ eye34],
                  dim=-2)                                    # (..., 6, 4)
    v4 = _smallest_right_singular(A)
    w = v4[..., 3]
    w = torch.where(torch.abs(w) < 1e-5, torch.where(w < 0, -1e-5, 1e-5), w)
    return v4[..., :3] / w[..., None]


def triangulate_depths(se3_a_from_b: SE3, v2a: Tensor, v2b: Tensor):
    """``triangulate`` and the point's depths: (point in B, depth in A,
    depth in B)."""
    p_b = triangulate(se3_a_from_b, v2a, v2b)
    p_a = se3lib.apply(se3_a_from_b, p_b)
    return p_b, p_a[..., 2], p_b[..., 2]


def _centred(src: Tensor, dst: Tensor, mask: Tensor | None):
    """Masked means and mean-free, masked points: (mu_s, mu_d, cs, cd,
    count)."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=torch.bool,
                          device=src.device)
    m = mask[..., None].to(src.dtype)
    wsum = torch.clamp(torch.sum(mask.to(src.dtype), dim=-1), min=1.0)
    mu_s = torch.sum(src * m, dim=-2) / wsum[..., None]
    mu_d = torch.sum(dst * m, dim=-2) / wsum[..., None]
    return (mu_s, mu_d, (src - mu_s[..., None, :]) * m,
            (dst - mu_d[..., None, :]) * m, wsum)


def umeyama_icp(src: Tensor, dst: Tensor, mask: Tensor | None = None) -> SE3:
    """Rigid alignment dst ~ R src + t from the SVD of the
    cross-covariance (cg::Tools::ComputeRtBySVD, src/Tools.cc:307-340);
    ``mask`` selects the correspondences. The SVD is ``svd3``'s, which
    cannot raise or sync."""
    mu_s, mu_d, cs, cd, _ = _centred(src, dst, mask)
    H = cs.transpose(-1, -2) @ cd                            # (..., 3, 3)
    U, _, V = svd3(H)
    d = det3(V @ U.transpose(-1, -2))
    S = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ S @ U.transpose(-1, -2)
    return SE3(R, mu_d - (R @ mu_s[..., None])[..., 0])


def horn_icp(src: Tensor, dst: Tensor, mask: Tensor | None = None) -> SE3:
    """Rigid alignment dst ~ R src + t by Horn's quaternion method
    (cg::Tools::ICP_QD, src/Tools.cc:349-431): the rotation quaternion is
    the eigenvector of the 4x4 matrix Q of the cross-covariance
    M = (1/n) sum d s^T with the largest eigenvalue (``sym_eigh``), and
    t = mu_dst - R mu_src, as the JAX package returns it."""
    mu_s, mu_d, cs, cd, wsum = _centred(src, dst, mask)
    M = (cs.transpose(-1, -2) @ cd) / wsum[..., None, None]
    delta = torch.stack([M[..., 1, 2] - M[..., 2, 1],
                         M[..., 2, 0] - M[..., 0, 2],
                         M[..., 0, 1] - M[..., 1, 0]], dim=-1)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eye3 = torch.eye(3, dtype=M.dtype, device=M.device)
    sym = M + M.transpose(-1, -2) - tr[..., None, None] * eye3
    top = torch.cat([tr[..., None, None], delta[..., None, :]], dim=-1)
    bottom = torch.cat([delta[..., :, None], sym], dim=-1)
    vals, vecs = sym_eigh(torch.cat([top, bottom], dim=-2))
    k = torch.argmax(vals, dim=-1)
    q = torch.gather(vecs, -1, k[..., None, None].expand(
        *vecs.shape[:-1], 1))[..., 0]                        # (w, x, y, z)
    R = se3lib.rot_from_quat(q)
    return SE3(R, mu_d - (R @ mu_s[..., None])[..., 0])


def sampson_error(essential: Tensor, v2a: Tensor, v2b: Tensor) -> Tensor:
    """First-order geometric (Sampson) error of z=1-plane correspondences
    under an essential matrix (SampsonusError,
    src/HomographyInit.cc:346-360); broadcasts over batches."""
    one_b = torch.ones_like(v2b[..., :1])
    x1 = torch.cat([v2b, one_b], dim=-1)
    x2 = torch.cat([v2a, torch.ones_like(v2a[..., :1])], dim=-1)
    Ex1 = (essential @ x1[..., None])[..., 0]
    Etx2 = (essential.transpose(-1, -2) @ x2[..., None])[..., 0]
    err = torch.sum(x2 * Ex1, dim=-1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return err * err / torch.clamp(denom, min=1e-12)
