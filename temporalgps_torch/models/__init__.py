from .emissions import BottleneckEmissions, DenseEmissions, LargeEmissions, ScalarEmissions
from .gauss_markov import GaussMarkov
from .lgssm import (
    LGSSM,
    filter_,
    latent_marginals,
    logpdf,
    marginals,
    marginals_diag,
    posterior,
    rand,
)

__all__ = [
    "GaussMarkov",
    "LGSSM",
    "ScalarEmissions",
    "DenseEmissions",
    "LargeEmissions",
    "BottleneckEmissions",
    "filter_",
    "latent_marginals",
    "logpdf",
    "marginals",
    "marginals_diag",
    "posterior",
    "rand",
]

