"""Per-step linear-Gaussian conditionals (temporalgps_tpu/ops/lgc.py): the
predict and update steps of the sequential Kalman filter, which is the
port's ground truth, the observations' predictive marginals, and the
sampling conditionals, whose standard normals are arguments. Every function
broadcasts over leading batch axes, so one step of the sequential loop, the
B blocks of the block engine and the N steps of the parallel engine share
them.

The updates by observation type: a scalar y (`posterior_and_lml_scalar`, a
square root), a small vector y with dense noise (`posterior_and_lml_small`,
the Cholesky factor of the innovation covariance), a large vector y with
diagonal noise (`posterior_and_lml_large`, every factor in the input space)
and a vector y seen through a bottleneck z = H x + h, y = C z + c + noise
(`posterior_and_lml_bottleneck`, the pseudo-point models: the large update
of z, carried back to x).
"""

import math

import torch

from ..config import POSTERIOR_JITTER, RAND_JITTER
from ..utils import psd
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize

_LOG2PI = math.log(2.0 * math.pi)


def _mT(X):
    return X.transpose(-1, -2)


def mv(A, x):
    """A x on the trailing axes, batched."""
    return torch.einsum("...ij,...j->...i", A, x)


def _logdet_from_chol(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def predict(x: Gaussian, A, a, Q) -> Gaussian:
    """N(A m + a, A P A^T + Q)."""
    return Gaussian(mv(A, x.mean) + a, A @ symmetrize(x.cov) @ _mT(A) + Q)


def predict_marginals(x: Gaussian, A, a, Q_diag):
    """Mean and variance diagonal of N(A m + a, A P A^T + diag(Q_diag)),
    without the dense output covariance: ((..., Dout), (..., Dout))."""
    v = torch.einsum("...ij,...jk,...ik->...i", A, symmetrize(x.cov), A) + Q_diag
    return mv(A, x.mean) + a, v


def conditional_rand(eps, x_point, A, a, Q):
    """A x + a + chol(Q + RAND_JITTER I) eps, the factor formed in float64
    (`psd.sample_factor`)."""
    return mv(A, x_point) + a + mv(psd.sample_factor(Q, RAND_JITTER), eps)


def posterior_and_lml_small(x: Gaussian, A, a, Q, y):
    """Kalman update for a vector observation y = A x + a + N(0, Q), through
    the Cholesky factor L of the innovation covariance S = A P A^T + Q:
    B = L^{-1} A P, alpha = L^{-1} (y - A m - a), posterior (m + B^T alpha,
    P - B^T B); returns the posterior and the lml of y."""
    m, P = x.mean, symmetrize(x.cov)
    V = A @ P
    L = psd.cholesky(symmetrize(V @ _mT(A) + Q))
    B = psd.tri_solve(L, V)
    alpha = psd.tri_solve(L, (y - (mv(A, m) + a))[..., None])[..., 0]
    lml = -0.5 * (y.shape[-1] * _LOG2PI + _logdet_from_chol(L) + (alpha * alpha).sum(-1))
    return Gaussian(m + mv(_mT(B), alpha), P - _mT(B) @ B), lml


def posterior_and_lml_large(x: Gaussian, A, a, Q_diag, y):
    """Kalman update for a large vector observation with diagonal noise,
    every factor D x D (the reference's LargeOutputLGC algebra): with
    Lp = chol(P + POSTERIOR_JITTER I), Bt = Q^{-1/2} A Lp and
    Lf = chol(Bt^T Bt + I), the posterior covariance is G^T G, G = Lf^{-1} Lp^T."""
    m = x.mean
    Din = A.shape[-1]
    Lp = psd.cholesky(psd.add_jitter(symmetrize(x.cov), POSTERIOR_JITTER))
    q_isqrt = 1.0 / torch.sqrt(Q_diag)
    Bt = (A * q_isqrt[..., None]) @ Lp
    eye = torch.eye(Din, dtype=m.dtype, device=m.device)
    Lf = psd.cholesky(symmetrize(_mT(Bt) @ Bt) + eye)
    G = psd.tri_solve(Lf, _mT(Lp))
    delta = q_isqrt * (y - (mv(A, m) + a))
    beta = psd.tri_solve(Lf, mv(_mT(Bt), delta)[..., None])[..., 0]
    lml = -0.5 * ((delta * delta).sum(-1) - (beta * beta).sum(-1) + y.shape[-1] * _LOG2PI
                  + _logdet_from_chol(Lf) + torch.log(Q_diag).sum(-1))
    return Gaussian(m + mv(_mT(G), beta), _mT(G) @ G), lml


def posterior_and_lml_scalar(x: Gaussian, H, h, s, y):
    """Kalman update for a scalar observation y = H x + h + N(0, s), H of
    shape (..., D); returns the posterior and the log marginal likelihood of
    y."""
    m, P = x.mean, symmetrize(x.cov)
    V = torch.einsum("...j,...jk->...k", H, P)
    sqrtS = torch.sqrt((V * H).sum(-1) + s)
    B = V / sqrtS[..., None]
    alpha = (y - ((H * m).sum(-1) + h)) / sqrtS
    lml = -0.5 * (_LOG2PI + 2.0 * torch.log(sqrtS) + alpha * alpha)
    return Gaussian(m + B * alpha[..., None], P - B[..., :, None] * B[..., None, :]), lml


def predict_marginals_scalar(x: Gaussian, H, h, s):
    """Mean and variance of the scalar y = H x + h + N(0, s), batched over
    leading axes: (H m + h, H P H^T + s)."""
    m = (H * x.mean).sum(-1) + h
    PH = (symmetrize(x.cov) @ H.unsqueeze(-1)).squeeze(-1)
    v = (H * PH).sum(-1) + s
    return m, v


def conditional_rand_scalar(eps, x_point, H, h, s):
    """H x + h + sqrt(s) eps, batched over leading axes."""
    return (H * x_point).sum(-1) + h + torch.sqrt(s) * eps


# ---------------------------------------------------------------------------
# The bottleneck: project to the pseudo-point space, then fan out
# ---------------------------------------------------------------------------

def project_bottleneck(x: Gaussian, H, h, eps=1e-12) -> Gaussian:
    """z = N(H m + h, H P H^T + eps I), the low-dimensional intermediate."""
    return Gaussian(mv(H, x.mean) + h, psd.add_jitter(H @ symmetrize(x.cov) @ _mT(H), eps))


def posterior_and_lml_bottleneck(x: Gaussian, H, h, C, c, Q_diag, y):
    """The update through the bottleneck: z's update by the large rule
    (`posterior_and_lml_large`), then x given z's posterior, with Gt =
    zP^{-1} H P: m + Gt^T (z'.m - z.m), P + Gt^T (z'.P - z.P) Gt."""
    z = project_bottleneck(x, H, h)
    z_post, lml = posterior_and_lml_large(z, C, c, Q_diag, y)
    xP = symmetrize(x.cov)
    Gt = psd.chol_solve(psd.cholesky(psd.add_jitter(z.cov, 1e-12)), H @ xP)
    return Gaussian(x.mean + mv(_mT(Gt), z_post.mean - z.mean),
                    xP + _mT(Gt) @ (z_post.cov - z.cov) @ Gt), lml


def predict_bottleneck(x: Gaussian, H, h, C, c, Q_diag) -> Gaussian:
    """The observation-space predictive through the bottleneck, dense."""
    return predict(project_bottleneck(x, H, h), C, c, torch.diag_embed(Q_diag))


def predict_marginals_bottleneck(x: Gaussian, H, h, C, c, Q_diag):
    """Mean and variance diagonal of the predictive through the
    bottleneck."""
    return predict_marginals(project_bottleneck(x, H, h), C, c, Q_diag)


def conditional_rand_bottleneck(eps, x_point, H, h, C, c, Q_diag):
    """C (H x + h) + c + sqrt(Q_diag + RAND_JITTER) eps."""
    return mv(C, mv(H, x_point) + h) + c + torch.sqrt(Q_diag + RAND_JITTER) * eps
