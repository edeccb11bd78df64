"""Space-time GPs (temporalgps_tpu/space_time/): a `Separable` kernel on a
`RectilinearGrid` compiles to an LGSSM whose state is the spatial grid
tensored with the temporal state (D = Ns * Dt) and whose emissions are the
Ns observations of each time step (DenseEmissions); the gp verbs
(`to_sde(GP(k))(grid, noise)` -> `logpdf`, `marginals`, `rand`,
`posterior`) take grids. `kron` is the factored engine of the same models,
which never builds the D-state LGSSM (engine="kron" on those verbs). The
pseudo-point models (pseudo_point.py: `dtcify`, `DTCSeparable`, `dtc`,
`elbo`, `approx_posterior_marginals(_at)`) keep the process at M spatial
pseudo-inputs (D = M * Dt) and take a grid or a `RegularInTime` (other
points at each time).
"""

from . import kron
from .grids import RectilinearGrid, RegularInTime, SpaceTimeGrid, regular_in_time
from .pseudo_point import (DTCSeparable, approx_posterior_marginals,
                           approx_posterior_marginals_at, dtc, dtcify, elbo)
from .separable import Separable

__all__ = [
    "RectilinearGrid",
    "RegularInTime",
    "SpaceTimeGrid",
    "Separable",
    "DTCSeparable",
    "kron",
    "regular_in_time",
    "dtc",
    "dtcify",
    "elbo",
    "approx_posterior_marginals",
    "approx_posterior_marginals_at",
]
