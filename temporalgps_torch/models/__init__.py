from .emissions import ScalarEmissions
from .gauss_markov import GaussMarkov
from .lgssm import LGSSM

__all__ = ["GaussMarkov", "LGSSM", "ScalarEmissions"]
