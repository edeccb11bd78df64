"""Per-step linear-Gaussian conditionals (temporalgps_tpu/ops/lgc.py): the
predict and scalar-update steps of the sequential Kalman filter, which is the
port's ground truth."""

import math

import torch

from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize

_LOG2PI = math.log(2.0 * math.pi)


def predict(x: Gaussian, A, a, Q) -> Gaussian:
    """N(A m + a, A P A^T + Q)."""
    m = A @ x.mean + a
    P = A @ symmetrize(x.cov) @ A.transpose(-1, -2) + Q
    return Gaussian(m, P)


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
