"""Emission containers (temporalgps_tpu/models/emissions.py). Ported:
ScalarEmissions, a scalar observation y[t] = H[t] x[t] + h[t] + N(0, s[t])."""

import dataclasses
from typing import Any

from ..ops import lgc
from ..utils.gaussian import Gaussian


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarEmissions:
    H: Any  # (N, D) or Fill((D,))
    h: Any  # (N,) or Fill(())
    s: Any  # (N,) or Fill(()): observation noise variance


def noise_cov(e: ScalarEmissions):
    """The per-step observation noise leaf, the one the missing-data
    machinery and posterior prediction replace."""
    return e.s


def replace_noise_cov(e: ScalarEmissions, new) -> ScalarEmissions:
    return dataclasses.replace(e, s=new)


def step_predict_marginals(x: Gaussian, e: ScalarEmissions):
    """Observation-space predictive (mean, variance), batched over leading
    axes of x and of the emission's leaves."""
    return lgc.predict_marginals_scalar(x, e.H, e.h, e.s)


def step_conditional_rand(eps, x_point, e: ScalarEmissions):
    """A sample of the scalar observation given the state x_point and the
    standard normal eps, batched over leading axes."""
    return lgc.conditional_rand_scalar(eps, x_point, e.H, e.h, e.s)
