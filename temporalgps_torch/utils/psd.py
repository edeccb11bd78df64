"""Covariance helpers (temporalgps_tpu/utils/psd.py, the part this port uses).

The reference unrolls the small Cholesky factorisation and triangular solves
for its TPU compiler; here `torch.linalg` does both, batched."""

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
