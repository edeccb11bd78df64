"""The separable space-time kernel k((r, t), (r', t')) = k_l(r, r') k_r(t, t')
(temporalgps_tpu/space_time/separable.py) and its dense grams, the oracle
of the state-space route."""

import dataclasses
from typing import Any

import torch

from ..gp import kernels as K
from ..utils import psd
from ..utils.regular_spacing import time_array
from . import grids


@dataclasses.dataclass(frozen=True, eq=False)
class Separable(K.Kernel):
    l: Any  # spatial kernel
    r: Any  # temporal kernel


def spatial_gram(k: Separable, x: grids.RectilinearGrid, dtype, device):
    """The gram Kr of the spatial kernel at the grid's points, with the
    dtype's jitter on its diagonal (dtype_jitter times its mean diagonal),
    in the storage dtype: the spatial factor of the exact grid model."""
    Kr = K.gram(k.l, torch.as_tensor(x.xl, device=device))
    eps = psd.dtype_jitter(dtype) * torch.diagonal(Kr).mean()
    return (Kr + eps * torch.eye(Kr.shape[0], dtype=Kr.dtype, device=device)).to(dtype)


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


def gram_diag_grid(k: Separable, x, device=None):
    """(Nt, Ns) per-time diagonal of the kernel over a grid or a
    RegularInTime's padded slices (one gram of all of them), on `device`
    where one is given."""
    dt = K.gram_diag(k.r, time_array(grids.get_times(x), device))
    if isinstance(x, grids.RectilinearGrid):
        return dt[:, None] * K.gram_diag(k.l, torch.as_tensor(x.xl, device=device))[None, :]
    if isinstance(x, grids.RegularInTime):
        vs = torch.as_tensor(x.vs_padded, device=device)
        return dt[:, None] * K.gram_diag(k.l, vs.flatten(0, 1)).reshape(vs.shape[:2])
    raise TypeError(type(x))
