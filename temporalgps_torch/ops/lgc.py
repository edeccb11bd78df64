"""Per-step linear-Gaussian conditionals (temporalgps_tpu/ops/lgc.py): the
predict and scalar-update steps of the sequential Kalman filter, which is the
port's ground truth, the scalar observation's predictive marginals, and the
sampling conditionals, whose standard normals are arguments."""

import math

import torch

from ..config import RAND_JITTER
from ..utils import psd
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize

_LOG2PI = math.log(2.0 * math.pi)


def predict(x: Gaussian, A, a, Q) -> Gaussian:
    """N(A m + a, A P A^T + Q)."""
    m = A @ x.mean + a
    P = A @ symmetrize(x.cov) @ A.transpose(-1, -2) + Q
    return Gaussian(m, P)


def conditional_rand(eps, x_point, A, a, Q):
    """A x + a + chol(Q + RAND_JITTER I) eps, batched over leading axes."""
    L = psd.cholesky(psd.add_jitter(symmetrize(Q), RAND_JITTER))
    mv = lambda M, v: torch.einsum("...ij,...j->...i", M, v)
    return mv(A, x_point) + a + mv(L, eps)


def posterior_and_lml_scalar(x: Gaussian, H, h, s, y):
    """Kalman update for a scalar observation y = H x + h + N(0, s); returns
    the posterior and the log marginal likelihood of y."""
    m, P = x.mean, symmetrize(x.cov)
    V = H @ P
    S = V @ H + s
    sqrtS = torch.sqrt(S)
    B = V / sqrtS
    alpha = (y - (H @ m + h)) / sqrtS
    lml = -0.5 * (_LOG2PI + 2.0 * torch.log(sqrtS) + alpha * alpha)
    m_post = m + B * alpha
    P_post = P - B[:, None] * B[None, :]
    return Gaussian(m_post, P_post), lml


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
