"""RegularSpacing(t0, dt, N) — regularly spaced times, the input that lets
the kernel compiler emit one shared transition (temporalgps_tpu/utils/
regular_spacing.py). t0 and dt are Python floats or 0-dim tensors."""

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class RegularSpacing:
    t0: Any
    dt: Any
    N: int

    def __len__(self):
        return self.N

    def to_array(self):
        t0, dt = _as_tensor(self.t0), _as_tensor(self.dt)
        dtype = torch.promote_types(t0.dtype, dt.dtype)
        return t0 + dt * torch.arange(self.N, dtype=dtype, device=dt.device)

    def stretch(self, a):
        """Time-axis rescaling t -> a*t."""
        return RegularSpacing(a * self.t0, a * self.dt, self.N)


def _as_tensor(v):
    # Python floats are float64, as in the reference under x64.
    return v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float64)


def time_array(x):
    """The times as a tensor, for either input representation."""
    return x.to_array() if isinstance(x, RegularSpacing) else torch.as_tensor(x)


def num_times(x) -> int:
    return x.N if isinstance(x, RegularSpacing) else len(x)
