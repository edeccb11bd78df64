"""Mean functions (temporalgps_tpu/gp/means.py): ZeroMean, ConstMean and
CustomMean, whose function is a Python callable on a tensor of times."""

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroMean:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class ConstMean:
    c: Any


@dataclasses.dataclass(frozen=True, eq=False)
class CustomMean:
    fn: Callable  # t -> mean, vectorised over a tensor of times


def mean_vector(m, t):
    """The mean function on a tensor of times, in the times' dtype."""
    t = torch.as_tensor(t)
    if isinstance(m, ZeroMean):
        return torch.zeros_like(t)
    if isinstance(m, ConstMean):
        return torch.as_tensor(m.c, dtype=t.dtype, device=t.device).expand(t.shape)
    if isinstance(m, CustomMean):
        return torch.as_tensor(m.fn(t))
    raise TypeError(type(m))
