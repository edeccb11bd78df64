from . import kernels
from .kernels import Kernel, Matern12, Matern32, Matern52, Scaled, Stretched
from .lti_sde import (
    GP,
    LTISDE,
    ArrayStorage,
    FiniteLTISDE,
    build_lgssm,
    logpdf,
    to_sde,
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
