"""The separable space-time kernel k((r, t), (r', t')) = k_l(r, r') k_r(t, t')
(temporalgps_tpu/space_time/separable.py) and its dense grams, the oracle
of the state-space route."""

import dataclasses
from typing import Any

import torch

from ..gp import kernels as K
from ..utils.regular_spacing import time_array
from . import grids


@dataclasses.dataclass(frozen=True, eq=False)
class Separable(K.Kernel):
    l: Any  # spatial kernel
    r: Any  # temporal kernel


def gram_grid(k: Separable, x: grids.RectilinearGrid):
    """The dense gram over a grid's flat (space-fastest) indexing:
    kron(K_time, K_space)."""
    return torch.kron(K.gram(k.r, time_array(x.xr)), K.gram(k.l, x.xl))


def gram_points(k: Separable, x, y=None):
    """The (len(x), len(y)) gram of off-grid inputs, each a pair
    (spatial points, times) of equal length."""
    xl, xr = x
    yl, yr = (xl, xr) if y is None else y
    return K.gram(k.l, xl, yl) * K.gram(k.r, xr, yr)


def _elementwise_k(k, x, y):
    """k(x_i, y_i) for each i, by single-point grams."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return torch.stack([K.gram(k, a[None], b[None])[0, 0] for a, b in zip(x, y)])


def gram_diag_points(k: Separable, x, y=None):
    """k((r_i, t_i), (r'_i, t'_i)) for each i of off-grid inputs; the
    diagonal of `gram_points(k, x)` when y is None."""
    xl, xr = x
    if y is None:
        return K.gram_diag(k.l, xl) * K.gram_diag(k.r, xr)
    yl, yr = y
    return _elementwise_k(k.l, xl, yl) * _elementwise_k(k.r, xr, yr)


def gram_diag_grid(k: Separable, x):
    """(Nt, Ns) per-time diagonal of the kernel over a grid or a
    RegularInTime's padded slices."""
    if isinstance(x, grids.RectilinearGrid):
        return K.gram_diag(k.r, time_array(x.xr))[:, None] * K.gram_diag(k.l, x.xl)[None, :]
    if isinstance(x, grids.RegularInTime):
        dr = torch.stack([K.gram_diag(k.l, v) for v in x.vs_padded])
        return K.gram_diag(k.r, time_array(x.ts))[:, None] * dr
    raise TypeError(type(x))
