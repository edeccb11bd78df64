from .fill import Fill, is_fill, tmaterialize
from .gaussian import Gaussian, gaussian_logpdf, gaussian_marginals, gaussian_rand
from .regular_spacing import RegularSpacing, num_times, time_array

__all__ = [
    "Fill",
    "Gaussian",
    "gaussian_logpdf",
    "gaussian_marginals",
    "gaussian_rand",
    "RegularSpacing",
    "is_fill",
    "num_times",
    "time_array",
    "tmaterialize",
]
