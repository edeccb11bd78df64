"""Unrolled small-matrix Kalman algebra on components (temporalgps_tpu/ops/lanes.py).

A D x D matrix (D <= 3) is a tuple of rows of *components*: (B,) tensors that
hold one matrix entry for each of B blocks, or 0-dim tensors / Python floats
for a value shared by all blocks. Every matrix operation unrolls to a few
element-wise tensor ops. These functions are the plain PyTorch versions of
the block engine's kernels (ops/kernels.py); csrc/lanes.cuh holds the same
algebra as device functions, in the same order of operations.
"""

import functools
import math
import operator
from typing import Tuple

import torch

Mat = Tuple[Tuple, ...]
Vec = Tuple

_LOG2PI = math.log(2.0 * math.pi)


def _sum(terms):
    return functools.reduce(operator.add, terms)


def mm(A: Mat, B: Mat) -> Mat:
    return tuple(
        tuple(_sum(A[i][k] * B[k][j] for k in range(len(B))) for j in range(len(B[0])))
        for i in range(len(A))
    )


def mmT(A: Mat, B: Mat) -> Mat:
    """A @ B^T"""
    return tuple(
        tuple(_sum(A[i][k] * B[j][k] for k in range(len(A[0]))) for j in range(len(B)))
        for i in range(len(A))
    )


def mTm(A: Mat, B: Mat) -> Mat:
    """A^T @ B"""
    return tuple(
        tuple(_sum(A[k][i] * B[k][j] for k in range(len(A))) for j in range(len(B[0])))
        for i in range(len(A[0]))
    )


def mv(A: Mat, x: Vec) -> Vec:
    return tuple(_sum(A[i][j] * x[j] for j in range(len(x))) for i in range(len(A)))


def mTv(A: Mat, x: Vec) -> Vec:
    return tuple(_sum(A[j][i] * x[j] for j in range(len(A))) for i in range(len(A[0])))


def vdot(a: Vec, b: Vec):
    return _sum(ai * bi for ai, bi in zip(a, b))


def outer(a: Vec, b: Vec) -> Mat:
    return tuple(tuple(ai * bj for bj in b) for ai in a)


def madd(A: Mat, B: Mat) -> Mat:
    return tuple(tuple(x + y for x, y in zip(ra, rb)) for ra, rb in zip(A, B))


def msub(A: Mat, B: Mat) -> Mat:
    return tuple(tuple(x - y for x, y in zip(ra, rb)) for ra, rb in zip(A, B))


def mscale(c, A: Mat) -> Mat:
    return tuple(tuple(c * x for x in row) for row in A)


def vadd(a: Vec, b: Vec) -> Vec:
    return tuple(x + y for x, y in zip(a, b))


def vsub(a: Vec, b: Vec) -> Vec:
    return tuple(x - y for x, y in zip(a, b))


def vscale(c, a: Vec) -> Vec:
    return tuple(c * x for x in a)


def sym(A: Mat) -> Mat:
    D = len(A)
    return tuple(tuple(0.5 * (A[i][j] + A[j][i]) for j in range(D)) for i in range(D))


def eye(D, ones, zeros):
    return tuple(tuple(ones if i == j else zeros for j in range(D)) for i in range(D))


def inv(A: Mat) -> Mat:
    """Adjugate inverse, D <= 3."""
    D = len(A)
    if D == 1:
        return ((1.0 / A[0][0],),)
    if D == 2:
        det = A[0][0] * A[1][1] - A[0][1] * A[1][0]
        r = 1.0 / det
        return ((A[1][1] * r, -A[0][1] * r), (-A[1][0] * r, A[0][0] * r))
    if D == 3:
        a, b, c = A[0]
        d, e, f = A[1]
        g, h, i = A[2]
        c00 = e * i - f * h
        c01 = f * g - d * i
        c02 = d * h - e * g
        det = a * c00 + b * c01 + c * c02
        r = 1.0 / det
        c10 = c * h - b * i
        c11 = a * i - c * g
        c12 = b * g - a * h
        c20 = b * f - c * e
        c21 = c * d - a * f
        c22 = a * e - b * d
        return (
            (c00 * r, c10 * r, c20 * r),
            (c01 * r, c11 * r, c21 * r),
            (c02 * r, c12 * r, c22 * r),
        )
    raise ValueError(f"component inverse only for D <= 3, got {D}")


def step_element(A: Mat, a: Vec, Q: Mat, H: Vec, h, s, y, ones, zeros):
    """Filtering element (A_e, b_e, C_e, eta_e, J_e) of one step with a scalar
    observation y of noise variance s."""
    D = len(a)
    QH = mv(Q, H)
    S = vdot(H, QH) + s
    K = vscale(1.0 / S, QH)
    ImKH = msub(eye(D, ones, zeros), outer(K, H))
    A_e = mm(ImKH, A)
    resid = y - (vdot(H, a) + h)
    b_e = vadd(a, vscale(resid, K))
    C_e = sym(mm(ImKH, Q))
    w = mTv(A, H)
    eta_e = vscale(resid / S, w)
    J_e = mscale(1.0 / S, outer(w, w))
    return (A_e, b_e, C_e, eta_e, J_e)


def combine(e_i, e_j):
    """Associative, non-commutative combination of filtering elements:
    e_i first, then e_j."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    D = len(b_i)
    CiJj = mm(C_i, J_j)
    M = inv(tuple(
        tuple(CiJj[i][j] + (1.0 if i == j else 0.0) for j in range(D))
        for i in range(D)
    ))
    AjM = mm(A_j, M)
    MAi = mm(M, A_i)
    A = mm(A_j, MAi)
    b = vadd(mv(AjM, vadd(b_i, mv(C_i, eta_j))), b_j)
    C = sym(madd(mmT(mm(AjM, C_i), A_j), C_j))
    eta = vadd(mTv(MAi, vsub(eta_j, mv(J_j, b_i))), eta_i)
    J = sym(madd(mTm(MAi, mm(J_j, A_i)), J_i))
    return (A, b, C, eta, J)


def kalman_step(m: Vec, P: Mat, A: Mat, a: Vec, Q: Mat, H: Vec, h, s, y):
    """Predict, scalar update and the step's log marginal likelihood."""
    mp = vadd(mv(A, m), a)
    Pp = madd(sym(mmT(mm(A, P), A)), Q)
    V = mv(Pp, H)  # Pp is symmetric: Pp H = (H Pp)^T
    S = vdot(H, V) + s
    resid = y - (vdot(H, mp) + h)
    lml = -0.5 * (_LOG2PI + torch.log(S) + resid * resid / S)
    K = vscale(1.0 / S, V)
    m_f = vadd(mp, vscale(resid, K))
    P_f = sym(msub(Pp, outer(K, V)))
    return m_f, P_f, lml
