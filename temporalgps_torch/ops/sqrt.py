"""Square-root parallel Kalman filtering (temporalgps_tpu/ops/sqrt.py):
engine="sqrt", and the block engine's `phase2="sqrt"`.

The covariance-form combine (ops/assoc.py) subtracts PSD products; in
float32 at large state dims that sits near a conditioning cliff. Here the
filtering element is kept as (A, b, U, eta, Z) with C = U U^T and J = Z Z^T,
and the combine works on the roots, so every covariance stays PSD by
construction. With K = U_i^T Z_j, Lam = I + K K^T, Gam = I + K^T K (Woodbury):

    M  := (I + C_i J_j)^{-1} = I - U_i Lam^{-1} K Z_j^T
    M U_i = U_i Lam^{-1},  M^T Z_j = Z_j Gam^{-1}

so the combined roots are single QR re-triangularisations

    U = tria([A_j U_i L_Lam^{-T},  U_j])
    Z = tria([A_i^T Z_j L_Gam^{-T},  Z_i])

and A, b and eta apply M and M^T through the rank-structured form. Both
Cholesky targets are I + a Gram matrix. Cost: about 2 QRs of (D, 2D), 2
small Cholesky factors and 10 (D, D) products a combine, 2-3 times the
covariance form's. The scan is `assoc._associative_scan`, in batched tensor
ops on the card as on the CPU (the reference runs it in XLA).

Reverse-mode autodiff through QR is undefined at the exactly rank-deficient
roots of zero-padded columns: differentiate the covariance-form engines.
"""

import torch

from ..models import emissions as em
from ..utils import psd
from ..utils.gaussian import Gaussian
from . import assoc
from .assoc import _mT, _mv

# The largest state dim the square-root combine takes (the reference's cap:
# its batched (D, 2D) QR took a TPU worker down at D = 741).
SQRT_MAX_D = 192


def check_dim(D):
    if D > SQRT_MAX_D:
        raise ValueError(
            f"square-root combine rejected at latent_dim={D} > {SQRT_MAX_D}: the batched "
            "(D, 2D) QR is capped at this size (ops/sqrt.py SQRT_MAX_D). Use "
            "engine='sequential' (exact) for big-state models."
        )


def tria(X):
    """(..., D, K), K >= D -> a (..., D, D) lower-triangular T with
    T T^T = X X^T, by QR of X^T."""
    return _mT(torch.linalg.qr(_mT(X), mode="r")[1])


def _pad_root(X, D):
    """(..., D, K) -> a (..., D, D) root of X X^T: zero columns appended
    when K < D, QR-compressed when K > D."""
    K = X.shape[-1]
    if K == D:
        return X
    if K < D:
        return torch.cat([X, X.new_zeros(*X.shape[:-1], D - K)], dim=-1)
    return tria(X)


def _combine_sqrt(e_i, e_j):
    """Square-root filtering elements combined, e_i first, batched."""
    A_i, b_i, U_i, eta_i, Z_i = e_i
    A_j, b_j, U_j, eta_j, Z_j = e_j
    D = A_i.shape[-1]
    I = torch.eye(D, dtype=A_i.dtype, device=A_i.device)

    K = _mT(U_i) @ Z_j
    L_lam = psd.cholesky(I + K @ _mT(K))
    L_gam = psd.cholesky(I + _mT(K) @ K)

    # U = tria([A_j U_i L_lam^{-T}, U_j]);  U_i L_lam^{-T} = (L_lam^{-1} U_i^T)^T
    U = tria(torch.cat([A_j @ _mT(psd.tri_solve(L_lam, _mT(U_i))), U_j], dim=-1))
    # Z = tria([A_i^T Z_j L_gam^{-T}, Z_i])
    ZjAi = _mT(Z_j) @ A_i
    Z = tria(torch.cat([_mT(psd.tri_solve(L_gam, ZjAi)), Z_i], dim=-1))

    # A = A_j M A_i = A_j A_i - (A_j U_i) Lam^{-1} K (Z_j^T A_i)
    A = A_j @ A_i - (A_j @ U_i) @ psd.chol_solve(L_lam, K @ ZjAi)
    # b = A_j M (b_i + C_i eta_j) + b_j
    v = b_i + _mv(U_i, _mv(_mT(U_i), eta_j))
    Mv = v - _mv(U_i, psd.chol_solve(L_lam, (K @ _mv(_mT(Z_j), v)[..., None]))[..., 0])
    b = _mv(A_j, Mv) + b_j
    # eta = A_i^T M^T (eta_j - J_j b_i) + eta_i,  M^T w = w - Z_j K^T Lam^{-1} U_i^T w
    w = eta_j - _mv(Z_j, _mv(_mT(Z_j), b_i))
    Mtw = w - _mv(Z_j, (_mT(K) @ psd.chol_solve(L_lam, _mv(_mT(U_i), w)[..., None]))[..., 0])
    return (A, b, U, _mv(_mT(A_i), Mtw) + eta_i, Z)


def _sqrt_elements(F, c, Q, e, y, x0):
    """Per-step square-root filtering elements, with the prior element in
    front: the algebra of `assoc._filter_elements` with the covariance legs
    as roots. Scalar emissions: U by the Joseph form tria([(I - K H) U_Q,
    K sqrt(s)]) and Z = F^T H^T / sqrt(S), zero-padded to (D, D); vector
    ones (the noise R dense, or diagonal as diag(s_diag)): U = tria([(I - K H)
    U_Q, K U_R]) and Z = F^T H^T L_S^{-T}, padded or compressed to (D, D)."""
    D = F.shape[-1]
    I = torch.eye(D, dtype=F.dtype, device=F.device)
    U_Q = psd.psd_root(Q)
    if isinstance(e, em.ScalarEmissions):
        H, h, s = e.H, e.h, e.s
        u = torch.einsum("nji,nj->ni", U_Q, H)  # U_Q^T H
        S = (u * u).sum(-1) + s
        K = _mv(Q, H) / S[:, None]
        ImKH = I - K[:, :, None] * H[:, None, :]
        resid = y - ((H * c).sum(-1) + h)
        U_e = tria(torch.cat([ImKH @ U_Q, (K * torch.sqrt(s)[:, None])[:, :, None]], dim=-1))
        w = torch.einsum("nji,nj->ni", F, H)  # F^T H
        elems = (ImKH @ F, c + K * resid[:, None], U_e, w * (resid / S)[:, None],
                 _pad_root((w / torch.sqrt(S)[:, None])[:, :, None], D))
    else:
        if isinstance(e, em.DenseEmissions):
            H, d, R = e.H, e.h, e.S
        else:
            H, d, R = e.C, e.c, torch.diag_embed(e.s_diag)
        HUq = H @ U_Q
        Ls = psd.cholesky(psd.symmetrize(HUq @ _mT(HUq) + R))
        K = _mT(psd.chol_solve(Ls, H @ Q))  # (N, D, Dout)
        ImKH = I - K @ H
        resid = y - (_mv(H, c) + d)
        U_e = tria(torch.cat([ImKH @ U_Q, K @ psd.psd_root(R)], dim=-1))
        Z_e = _pad_root(_mT(F) @ _mT(psd.tri_solve(Ls, H)), D)
        Sinv_resid = psd.chol_solve(Ls, resid[..., None])[..., 0]
        elems = (ImKH @ F, c + _mv(K, resid), U_e, _mv(_mT(F), _mv(_mT(H), Sinv_resid)), Z_e)
    z = F.new_zeros(1, D, D)
    prior = (z, x0.mean[None].to(F), psd.psd_root(x0.cov)[None].to(F), F.new_zeros(1, D), z)
    return tuple(torch.cat([p, e]) for p, e in zip(prior, elems))


def to_sqrt_element(e):
    """A covariance-form element tuple (A, b, C, eta, J) in square-root form
    (the block engine's phase-1/phase-2 boundary; `psd.psd_root`, because the
    prior element's C and J legs are singular)."""
    A, b, C, eta, J = e
    return (A, b, psd.psd_root(C), eta, psd.psd_root(J))


def from_sqrt_element(e):
    A, b, U, eta, Z = e
    return (A, b, U @ _mT(U), eta, Z @ _mT(Z))


def _filter_prefix(model, y):
    """`assoc._filter_prefix` on the square-root recursion: the covariances
    are formed as U U^T only at the output."""
    check_dim(model.latent_dim)
    ev = assoc._iteration_view(model)
    it, emis_it, y_it = assoc._iteration_order(model, y)
    elems = _sqrt_elements(*ev, emis_it, y_it, model.trans.x0)
    _, b, U, _, _ = assoc._associative_scan(_combine_sqrt, elems)
    return Gaussian(b, U @ _mT(U)), ev, it, emis_it, y_it


def filter_(model, y) -> Gaussian:
    """Filtering distributions at every step, in time order."""
    outs = _filter_prefix(model, y)[0]
    return assoc._unflip(model, Gaussian(outs.mean[1:], outs.cov[1:]))


def logpdf(model, y):
    """Log marginal likelihood, either ordering."""
    outs, ev, _, emis_it, y_it = _filter_prefix(model, y)
    return assoc._logpdf_from_prefix(outs, ev, emis_it, y_it)


def posterior(model, y):
    """The smoother as an LGSSM of the opposite ordering from the
    square-root filtering prefixes (the post-processing of assoc.posterior)."""
    outs, _, it, _, _ = _filter_prefix(model, y)
    return assoc._posterior_from_prefix(model, outs, it)
