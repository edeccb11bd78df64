"""Emission containers (temporalgps_tpu/models/emissions.py). Ported:
ScalarEmissions, a scalar observation y[t] = H[t] x[t] + h[t] + N(0, s[t])."""

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarEmissions:
    H: Any  # (N, D) or Fill((D,))
    h: Any  # (N,) or Fill(())
    s: Any  # (N,) or Fill(()): observation noise variance
