from .emissions import DenseEmissions, LargeEmissions, ScalarEmissions
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
    "filter_",
    "latent_marginals",
    "logpdf",
    "marginals",
    "marginals_diag",
    "posterior",
    "rand",
]


def __getattr__(name):
    if name == "BottleneckEmissions":
        from . import emissions

        return emissions.BottleneckEmissions  # raises, naming its ROADMAP item
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
