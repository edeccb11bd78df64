"""Covariance helpers (temporalgps_tpu/utils/psd.py, the part this port uses).

The reference unrolls the small Cholesky factorisation and triangular solves
for its TPU compiler; here `torch.linalg` does both, batched."""

import functools

import torch

from ..config import IDENT_EPS


def symmetrize(P):
    """0.5 (P + P^T) on the trailing two axes."""
    return 0.5 * (P + P.transpose(-1, -2))


def add_jitter(P, eps=IDENT_EPS):
    """P + eps I on the trailing two axes."""
    return P + eps * torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)


def cholesky(P):
    """Lower Cholesky factor, batched over leading axes."""
    return torch.linalg.cholesky(P)


def chol_solve(L, B):
    """Solve (L L^T) X = B given the lower Cholesky factor L; batched."""
    return torch.cholesky_solve(B, L)


def block_diag(mats):
    """Dense block-diagonal of a list of (..., Di, Ei) matrices, whose leading
    axes broadcast (the per-step (N, D, D) leaves of irregular times beside
    constant (D, D) ones). Built from concatenations, without writes into a
    buffer, so that it also runs under torch.func transforms."""
    if len(mats) == 1:
        return mats[0]
    batch = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
    dtype = functools.reduce(torch.promote_types, (m.dtype for m in mats))
    cols = [m.shape[-1] for m in mats]
    total = sum(cols)
    rows = []
    start = 0
    for m, c in zip(mats, cols):
        m = m.to(dtype).expand(*batch, *m.shape[-2:])
        r = m.shape[-2]
        rows.append(torch.cat([m.new_zeros(*batch, r, start), m,
                               m.new_zeros(*batch, r, total - start - c)], dim=-1))
        start += c
    return torch.cat(rows, dim=-2)
