"""The dense GP, the O(N^3) oracle the tests hold the state-space engines to
(temporalgps_tpu/gp/dense.py). Never on a hot path."""

import math

import torch

from ..utils.fill import tmaterialize
from ..utils.regular_spacing import time_array
from . import kernels as K
from .lti_sde import _storage_dtype
from .means import mean_vector


def _times(fx):
    return time_array(fx.x, fx.f.device).to(_storage_dtype(fx.f.storage))


def dense_mean_cov(fx):
    """(mean (N,), covariance (N, N)) of the observations, the noise
    included."""
    t = _times(fx)
    m = mean_vector(fx.f.f.mean, t)
    C = K.gram(fx.f.f.kernel, t) + torch.diag(tmaterialize(fx.noise))
    return m, C


def dense_logpdf(fx, y):
    m, C = dense_mean_cov(fx)
    L = torch.linalg.cholesky(C)
    alpha = torch.linalg.solve_triangular(L, (torch.as_tensor(y).to(m) - m)[:, None],
                                          upper=False)[:, 0]
    return -0.5 * (m.shape[0] * math.log(2 * math.pi)
                   + 2 * torch.log(torch.diagonal(L)).sum() + (alpha * alpha).sum())


def dense_marginals(fx):
    m, C = dense_mean_cov(fx)
    return m, torch.diagonal(C)
