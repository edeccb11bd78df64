"""Mean functions (temporalgps_tpu/gp/means.py): ZeroMean and ConstMean."""

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroMean:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class ConstMean:
    c: Any
