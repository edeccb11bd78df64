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

Hyperparameters are fitted on the lml and its forward-mode gradient, which
runs the primal and k tangent filters through one pass of kernels
(learning.value_and_grad_fwd_lgssm, fit, fit_lbfgs).

The JAX package temporalgps_tpu is the reference this port is held to.
"""

from .gp.lti_sde import logpdf
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
    "fit",
    "fit_lbfgs",
    "positive",
    "constrained",
    "value_and_grad_fwd",
    "value_and_grad_fwd_lgssm",
]
