"""temporalgps_torch — the PyTorch and CUDA port of temporalgps_tpu.

A GP on a time series compiles to a linear-Gaussian state-space model
(LGSSM) whose log marginal likelihood is a Kalman filter. On a CUDA device
the block-parallel filter runs on kernels written by hand for Hopper
(ops/kernels.py, csrc/); on the CPU it runs their plain PyTorch versions.

Dtypes and devices are explicit, never detected:

    fx = to_sde(GP(Matern52()), ArrayStorage(torch.float32), device="cuda")(
        RegularSpacing(0.0, 1e-3, N), 0.1)
    lml = logpdf(fx, y)

The JAX package temporalgps_tpu is the reference this port is held to.
"""

from .gp.lti_sde import logpdf
from .utils.regular_spacing import RegularSpacing

__all__ = ["RegularSpacing", "logpdf"]
