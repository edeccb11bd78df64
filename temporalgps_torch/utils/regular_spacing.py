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

    def to_array(self, device=None):
        """The N times, on `device` (default: where dt lies)."""
        t0, dt = _as_tensor(self.t0, device), _as_tensor(self.dt, device)
        dtype = torch.promote_types(t0.dtype, dt.dtype)
        return t0 + dt * torch.arange(self.N, dtype=dtype, device=dt.device)

    def stretch(self, a):
        """Time-axis rescaling t -> a*t."""
        return RegularSpacing(a * self.t0, a * self.dt, self.N)


def _as_tensor(v, device=None):
    # Python floats are float64, as in the reference under x64.
    if torch.is_tensor(v):
        return v if device is None else v.to(device)
    return torch.tensor(v, dtype=torch.float64, device=device)


def time_array(x, device=None):
    """The times as a tensor, for either input representation; on `device`
    where one is given."""
    if isinstance(x, RegularSpacing):
        return x.to_array(device)
    return torch.as_tensor(x, device=device)


def num_times(x) -> int:
    return x.N if isinstance(x, RegularSpacing) else len(x)
