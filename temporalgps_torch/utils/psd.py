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


def dtype_jitter(dtype, f64_eps=IDENT_EPS, f32_eps=1e-5):
    """A jitter for the storage dtype: the reference's 1e-12 constants
    assume float64; a near-singular float32 gram (a dense EQ kernel matrix)
    needs ~1e-5 relative regularisation to stay positive definite."""
    return f64_eps if torch.finfo(dtype).bits >= 64 else f32_eps


def cholesky(P):
    """Lower Cholesky factor, batched over leading axes."""
    return torch.linalg.cholesky(P)


def sample_factor(Q, jitter):
    """chol(Q + jitter I), the factor a sample draws its noise through,
    batched: formed in float64 from Q as it is stored, then stored in Q's
    dtype. A float32 covariance whose smallest eigenvalues lie below
    float32's resolution of its largest (a space-time model's Kr (x) Q_t at
    D = 741) has no float32 factor with the reference's jitter; widened, the
    same stored values factor."""
    return cholesky(add_jitter(symmetrize(Q).to(torch.float64), jitter)).to(Q.dtype)


def tri_solve(L, B):
    """Solve L X = B for lower-triangular L; batched."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_solve(L, B):
    """Solve (L L^T) X = B given the lower Cholesky factor L; batched: two
    triangular solves, as the reference's. (torch.cholesky_solve's batched
    CUDA path is far slower on many small systems:
    probes/torch_fisher_ops.py.)"""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), tri_solve(L, B), upper=True)


def _chol_unrolled(P, D):
    """Closed-form Cholesky factor for D <= 4, elementwise over leading axes,
    that takes semidefinite P: each pivot clamped at 0, the column below a
    zero pivot zero."""
    L = [[None] * D for _ in range(D)]
    for j in range(D):
        s = P[..., j, j] - sum(L[j][k] * L[j][k] for k in range(j))
        L[j][j] = torch.sqrt(torch.clamp_min(s, 0.0))
        inv = torch.where(L[j][j] > 0, 1.0 / torch.where(L[j][j] > 0, L[j][j], 1.0), 0.0)
        for i in range(j + 1, D):
            L[i][j] = (P[..., i, j] - sum(L[i][k] * L[j][k] for k in range(j))) * inv
    zero = torch.zeros_like(P[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(D)], dim=-1)
                        for i in range(D)], dim=-2)


def psd_root(P):
    """A square root U, U U^T = P, of a symmetric PSD P that may be singular
    (the zero covariance of the prior element, a zero process noise): the
    unrolled semidefinite Cholesky factor for D <= 4, else the symmetric
    eigendecomposition with its eigenvalues clamped at 0 (the reference's
    `psd.psd_root`)."""
    P = symmetrize(P)
    D = P.shape[-1]
    if D <= 4:
        return _chol_unrolled(P, D)
    w, V = torch.linalg.eigh(P)
    return V * torch.sqrt(torch.clamp_min(w, 0.0))[..., None, :]


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
