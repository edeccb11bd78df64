from .fill import Fill, is_fill, tmaterialize
from .gaussian import Gaussian
from .regular_spacing import RegularSpacing, num_times, time_array

__all__ = [
    "Fill",
    "Gaussian",
    "RegularSpacing",
    "is_fill",
    "num_times",
    "time_array",
    "tmaterialize",
]
