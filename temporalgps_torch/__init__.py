"""temporalgps_torch — the PyTorch and CUDA port of temporalgps_tpu.

A GP on a time series compiles to a linear-Gaussian state-space model
(LGSSM) whose log marginal likelihood is a Kalman filter. On a CUDA device
the block-parallel filter runs on kernels written by hand for Hopper
(ops/kernels.py, csrc/); on the CPU it runs their plain PyTorch versions.

Dtypes and devices are explicit, never detected. A model lives on the CUDA
card unless the caller asks for the CPU with `to_sde(..., device="cpu")`:

    fx = to_sde(GP(Matern52()), ArrayStorage(torch.float32))(
        RegularSpacing(0.0, 1e-3, N), 0.1)
    lml = logpdf(fx, y)

Kernels compose: `0.5 * Matern12().stretch(2.0) + Matern32()` is a Sum
(the direct sum of the two state spaces), `Matern12() * Matern32()` a
Product; `GP(k, CustomMean(fn))` takes a mean function of the times.

Prediction: `marginals(fx)` gives the prior's (means, variances), and
`gp.posterior.marginals(posterior(fx, y)(x_new, noise))` the posterior's at
the training or at new inputs, through the smoother as a reverse-ordered
LGSSM (ops/block.py on K1, K2, K7 and the affine kernels K8-K10).
Sampling: `rand(generator, fx)` draws from the prior and
`gp.posterior.rand(generator, fxp)` from the posterior, with an explicit
torch.Generator on the model's device (K8-K10); `gp.posterior.logpdf(fxp,
y_new)` scores new data under the posterior (the reverse model's filter on
K1, K2, K3).

Hyperparameters are fitted on the lml and its forward-mode gradient, which
runs the primal and k tangent filters through one pass of kernels
(learning.value_and_grad_fwd_lgssm, fit, fit_lbfgs).

The JAX package temporalgps_tpu is the reference this port is held to.
"""

from .gp.lti_sde import logpdf, marginals, mean, mean_and_var, rand, var
from .gp.posterior import posterior
from .learning import (
    constrained,
    fit,
    fit_lbfgs,
    positive,
    value_and_grad_fwd,
    value_and_grad_fwd_lgssm,
)
from .utils.regular_spacing import RegularSpacing

__all__ = [
    "RegularSpacing",
    "logpdf",
    "rand",
    "posterior",
    "marginals",
    "mean",
    "var",
    "mean_and_var",
    "fit",
    "fit_lbfgs",
    "positive",
    "constrained",
    "value_and_grad_fwd",
    "value_and_grad_fwd_lgssm",
]
