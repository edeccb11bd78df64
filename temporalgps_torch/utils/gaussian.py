"""Gaussian(mean (..., D), cov (..., D, D)) (temporalgps_tpu/utils/gaussian.py)."""

import dataclasses

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
