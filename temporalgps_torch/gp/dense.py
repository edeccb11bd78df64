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


def dense_posterior_marginals(fx, y, fx_pred):
    """Posterior (means, variances) at fx_pred's inputs, fx_pred's noise
    included, given y observed at fx's."""
    t_tr, t_pr = _times(fx), _times(fx_pred)
    kern, mean = fx.f.f.kernel, fx.f.f.mean
    m_tr, m_pr = mean_vector(mean, t_tr), mean_vector(mean, t_pr)
    C_tr = K.gram(kern, t_tr) + torch.diag(tmaterialize(fx.noise))
    C_cross = K.gram(kern, t_pr, t_tr)
    C_pr = K.gram(kern, t_pr) + torch.diag(tmaterialize(fx_pred.noise))
    sol = torch.linalg.solve(C_tr, torch.as_tensor(y).to(m_tr) - m_tr)
    cov = C_pr - C_cross @ torch.linalg.solve(C_tr, C_cross.T)
    return m_pr + C_cross @ sol, torch.diagonal(cov)
