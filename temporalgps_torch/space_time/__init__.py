"""Space-time GPs (temporalgps_tpu/space_time/): a `Separable` kernel on a
`RectilinearGrid` compiles to an LGSSM whose state is the spatial grid
tensored with the temporal state (D = Ns * Dt) and whose emissions are the
Ns observations of each time step (DenseEmissions); the gp verbs
(`to_sde(GP(k))(grid, noise)` -> `logpdf`, `marginals`, `rand`,
`posterior`) take grids. The factored Kronecker engine (engine="kron") is
ROADMAP Queue 1 item 7b; the pseudo-point models (`dtc`, `elbo`, `dtcify`,
`DTCSeparable`, `approx_posterior_marginals(_at)`) and the use of
`RegularInTime` inputs are item 8.
"""

from .grids import RectilinearGrid, RegularInTime, SpaceTimeGrid, regular_in_time
from .separable import Separable

__all__ = [
    "RectilinearGrid",
    "RegularInTime",
    "SpaceTimeGrid",
    "Separable",
    "regular_in_time",
]

_PSEUDO_POINT = ("dtc", "elbo", "dtcify", "DTCSeparable", "approx_posterior_marginals",
                 "approx_posterior_marginals_at")


def __getattr__(name):
    if name in _PSEUDO_POINT:
        raise NotImplementedError(
            f"space_time.{name}: the pseudo-point (DTC) models are not ported yet "
            "(ROADMAP Queue 1 item 8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
