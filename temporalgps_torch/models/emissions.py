"""Emission containers (temporalgps_tpu/models/emissions.py) and the step
functions that dispatch on them. Ported:

  * ScalarEmissions — a scalar y[t] = H[t] x[t] + h[t] + N(0, s[t]);
  * DenseEmissions  — a vector y[t] = H[t] x[t] + h[t] + N(0, S[t]) with a
                      dense noise covariance (the exact space-time models);
  * LargeEmissions  — the same with a diagonal noise s_diag[t], conditioned in
                      the input space (Dout >> D).

BottleneckEmissions waits for the pseudo-point models (ROADMAP Queue 1
item 8). Every leaf carries a leading time axis or is a Fill; the step
functions take one step's slice of the leaves and broadcast over leading
batch axes, so the sequential, block and parallel engines share them.
"""

import dataclasses
from typing import Any

import torch

from ..ops import lgc
from ..utils.fill import is_fill
from ..utils.gaussian import Gaussian


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarEmissions:
    H: Any  # (N, D) or Fill((D,))
    h: Any  # (N,) or Fill(())
    s: Any  # (N,) or Fill(()): observation noise variance


@dataclasses.dataclass(frozen=True, eq=False)
class DenseEmissions:
    H: Any  # (N, Dout, D) or Fill((Dout, D))
    h: Any  # (N, Dout) or Fill((Dout,))
    S: Any  # (N, Dout, Dout) or Fill((Dout, Dout)): observation noise covariance


@dataclasses.dataclass(frozen=True, eq=False)
class LargeEmissions:
    C: Any       # (N, Dout, D) or Fill((Dout, D))
    c: Any       # (N, Dout) or Fill((Dout,))
    s_diag: Any  # (N, Dout) or Fill((Dout,)): diagonal observation noise


_NOISE = {ScalarEmissions: "s", DenseEmissions: "S", LargeEmissions: "s_diag"}


def map_leaves(fn, e):
    """The container with fn applied to each of its leaves."""
    return dataclasses.replace(e, **{f.name: fn(getattr(e, f.name))
                                     for f in dataclasses.fields(e)})


def leaves(e):
    """The container's leaves in field order."""
    return tuple(getattr(e, f.name) for f in dataclasses.fields(e))


def num_steps(e) -> int:
    leaf = e.H if isinstance(e, (ScalarEmissions, DenseEmissions)) else e.C
    return leaf.N if is_fill(leaf) else leaf.shape[0]


def noise_cov(e):
    """The per-step observation noise leaf, the one the missing-data
    machinery and posterior prediction replace."""
    return getattr(e, _NOISE[type(e)])


def replace_noise_cov(e, new):
    return dataclasses.replace(e, **{_NOISE[type(e)]: new})


def step_posterior_and_lml(x: Gaussian, e, y):
    """The Kalman update of x by the observation y, and its lml."""
    if isinstance(e, ScalarEmissions):
        return lgc.posterior_and_lml_scalar(x, e.H, e.h, e.s, y)
    if isinstance(e, DenseEmissions):
        return lgc.posterior_and_lml_small(x, e.H, e.h, e.S, y)
    if isinstance(e, LargeEmissions):
        return lgc.posterior_and_lml_large(x, e.C, e.c, e.s_diag, y)
    raise TypeError(type(e))


def step_predict(x: Gaussian, e) -> Gaussian:
    """The observation-space predictive, its covariance dense (for scalar
    emissions the variance, scalar-shaped, as the reference's)."""
    if isinstance(e, ScalarEmissions):
        return Gaussian(*lgc.predict_marginals_scalar(x, e.H, e.h, e.s))
    if isinstance(e, DenseEmissions):
        return lgc.predict(x, e.H, e.h, e.S)
    if isinstance(e, LargeEmissions):
        return lgc.predict(x, e.C, e.c, torch.diag_embed(e.s_diag))
    raise TypeError(type(e))


def step_predict_marginals(x: Gaussian, e):
    """Observation-space predictive (mean, variance diagonal), batched over
    leading axes of x and of the emission's leaves."""
    if isinstance(e, ScalarEmissions):
        return lgc.predict_marginals_scalar(x, e.H, e.h, e.s)
    if isinstance(e, DenseEmissions):
        return lgc.predict_marginals(x, e.H, e.h, torch.diagonal(e.S, dim1=-2, dim2=-1))
    if isinstance(e, LargeEmissions):
        return lgc.predict_marginals(x, e.C, e.c, e.s_diag)
    raise TypeError(type(e))


def step_conditional_rand(eps, x_point, e):
    """A sample of the observation given the state x_point and the standard
    normals eps ((...,) scalar, (..., Dout) vector), batched over leading
    axes."""
    if isinstance(e, ScalarEmissions):
        return lgc.conditional_rand_scalar(eps, x_point, e.H, e.h, e.s)
    if isinstance(e, DenseEmissions):
        return lgc.conditional_rand(eps, x_point, e.H, e.h, e.S)
    if isinstance(e, LargeEmissions):
        return lgc.mv(e.C, x_point) + e.c + torch.sqrt(e.s_diag) * eps
    raise TypeError(type(e))


def dim_out(e) -> int:
    """The observation dimension of a step."""
    if isinstance(e, ScalarEmissions):
        return 1
    h = e.h if isinstance(e, DenseEmissions) else e.c
    return (h.value if is_fill(h) else h).shape[-1]


def __getattr__(name):
    if name == "BottleneckEmissions":
        raise NotImplementedError("BottleneckEmissions (the pseudo-point models' emissions) "
                                  "are not ported yet (ROADMAP Queue 1 item 8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
