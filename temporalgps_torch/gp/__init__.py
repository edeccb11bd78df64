from . import kernels
from .kernels import Kernel, Matern12, Matern32, Matern52, Scaled, Stretched
from .lti_sde import (
    GP,
    LTISDE,
    ArrayStorage,
    FiniteLTISDE,
    build_lgssm,
    logpdf,
    marginals,
    mean,
    mean_and_var,
    to_sde,
    var,
)
from .means import ConstMean, ZeroMean

__all__ = [
    "GP",
    "LTISDE",
    "FiniteLTISDE",
    "ArrayStorage",
    "to_sde",
    "build_lgssm",
    "logpdf",
    "marginals",
    "mean",
    "var",
    "mean_and_var",
    "Kernel",
    "Matern12",
    "Matern32",
    "Matern52",
    "Scaled",
    "Stretched",
    "ZeroMean",
    "ConstMean",
    "kernels",
]
