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
Product; `GP(k, CustomMean(fn))` takes a mean function of the times. The
deterministic kernels Cosine, Constant and ApproxPeriodic (no process
noise) join a sum as basis functions: `logpdf` marginalises them against
the model of the stochastic summands (engine="basis", ops/basis.py,
`basis_setup`; sub-engines "sequential", "block" and "steady").

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
(learning.value_and_grad_fwd_lgssm, fit, fit_lbfgs), or on the Fisher
identity's gradient, whose cost does not grow with the number of
hyperparameters (learning.value_and_grad_fisher: the posterior, its
marginals and the filter, engine="block" on K1-K3, K7 and K8-K10).

Space-time GPs (space_time/): `Separable(EQ().stretch(0.7), Matern52())` on a
`RectilinearGrid(points, times)` compiles to an LGSSM of D = Ns * Dt states
with Ns observations a step (DenseEmissions); the same verbs take and give
flat (space-fastest) vectors, and `posterior` predicts at new times on the
same spatial points. The pseudo-point models keep the process at M spatial
pseudo-inputs z: `dtc(fx, y, z)`, `elbo(fx, y, z)` and
`approx_posterior_marginals(fx, y, z, points)`, on a grid or a
`RegularInTime` (other points at each time).

Engines: "block" (the kernels), "sequential" (the ground truth, a loop over
time), "parallel" (an associative scan over all N steps, ops/assoc.py) and
"sqrt" (the same in square-root form, ops/sqrt.py), and for time-invariant
models "lti" (ops/lti.py) and "steady" (ops/steady.py, the converged
covariance after a warmup), chosen per call with `engine=`.

The JAX package temporalgps_tpu is the reference this port is held to.
"""

from . import space_time
from .gp.kernels import ApproxPeriodic, Constant, Cosine
from .gp.lti_sde import basis_setup, logpdf, marginals, mean, mean_and_var, rand, var
from .gp.posterior import posterior
from .space_time import (DTCSeparable, RectilinearGrid, RegularInTime, Separable,
                         approx_posterior_marginals, approx_posterior_marginals_at, dtc, dtcify,
                         elbo, regular_in_time)
from .learning import (
    constrained,
    fit,
    fit_lbfgs,
    positive,
    value_and_grad_fisher,
    value_and_grad_fwd,
    value_and_grad_fwd_lgssm,
)
from .utils.regular_spacing import RegularSpacing

__all__ = [
    "space_time",
    "RegularSpacing",
    "Cosine",
    "Constant",
    "ApproxPeriodic",
    "basis_setup",
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
    "value_and_grad_fisher",
    "Separable",
    "DTCSeparable",
    "RectilinearGrid",
    "RegularInTime",
    "regular_in_time",
    "dtc",
    "dtcify",
    "elbo",
    "approx_posterior_marginals",
    "approx_posterior_marginals_at",
]
