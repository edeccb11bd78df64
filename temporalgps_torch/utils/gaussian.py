"""Gaussian(mean (..., D), cov (..., D, D)) (temporalgps_tpu/utils/gaussian.py)."""

import dataclasses
import math

import torch

from ..config import IDENT_EPS
from . import psd


@dataclasses.dataclass(frozen=True, eq=False)
class Gaussian:
    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def dtype(self):
        return self.mean.dtype


def gaussian_rand(generator, x: Gaussian, sample_shape=()):
    """A sample with the IDENT_EPS-jittered Cholesky factor, the normals
    drawn from `generator` (a torch.Generator on x's device)."""
    L = psd.cholesky(psd.add_jitter(psd.symmetrize(x.cov), IDENT_EPS))
    eps = torch.randn(tuple(sample_shape) + tuple(x.mean.shape), generator=generator,
                      dtype=x.mean.dtype, device=x.mean.device)
    return x.mean + torch.einsum("...ij,...j->...i", L, eps)


def gaussian_logpdf(x: Gaussian, y):
    """log N(y; mean, cov), batched over leading axes."""
    L = psd.cholesky(psd.symmetrize(x.cov))
    alpha = psd.tri_solve(L, (y - x.mean)[..., None])[..., 0]
    logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (x.dim * math.log(2 * math.pi) + logdet + (alpha * alpha).sum(-1))


def gaussian_marginals(x: Gaussian):
    """Per-dimension (means, variances)."""
    return x.mean, torch.diagonal(x.cov, dim1=-2, dim2=-1)
