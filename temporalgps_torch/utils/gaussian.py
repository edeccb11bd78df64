"""Gaussian(mean (..., D), cov (..., D, D)) (temporalgps_tpu/utils/gaussian.py)."""

import dataclasses

import torch


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
