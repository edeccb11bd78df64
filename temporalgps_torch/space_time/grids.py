"""Space-time inputs and the flat <-> time-form data protocol
(temporalgps_tpu/space_time/grids.py).

A flat vector of observations indexes space fastest, so it reshapes to
(Nt, Ns) time-major blocks. `RegularInTime` (other spatial points at each
time) is stored padded to the longest slice with per-time counts; its
padding observes nothing (NaN, the missing-data fill). Exact inference
takes a `RectilinearGrid`; a `RegularInTime` is a container here, for the
pseudo-point models (ROADMAP Queue 1 item 8).
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.regular_spacing import num_times


@dataclasses.dataclass(frozen=True, eq=False)
class RectilinearGrid:
    """Space x time product grid: `xl` spatial points (Ns,) or (Ns, Dx);
    `xr` times (RegularSpacing or (Nt,))."""

    xl: Any
    xr: Any

    def __len__(self):
        return self.xl.shape[0] * num_times(self.xr)


SpaceTimeGrid = RectilinearGrid


@dataclasses.dataclass(frozen=True, eq=False)
class RegularInTime:
    """Ragged space-time inputs: times (Nt,), padded spatial points
    (Nt, max_n) or (Nt, max_n, Dx), and the per-time counts of genuine
    points."""

    ts: Any
    vs_padded: Any
    counts: tuple

    def __len__(self):
        return int(sum(self.counts))

    @property
    def max_n(self) -> int:
        return self.vs_padded.shape[1]


def regular_in_time(ts, vs_list) -> RegularInTime:
    """A RegularInTime from a list of per-time spatial point arrays; each
    slice pads with its first point (finite kernel matrices; the padding is
    never observed)."""
    counts = tuple(int(np.shape(v)[0]) for v in vs_list)
    first = np.asarray(vs_list[0])
    padded = np.zeros((len(vs_list), max(counts)) + first.shape[1:], dtype=first.dtype)
    for i, v in enumerate(vs_list):
        v = np.asarray(v)
        padded[i, : v.shape[0]] = v
        padded[i, v.shape[0]:] = v[0] if v.shape[0] else 0.0
    return RegularInTime(torch.as_tensor(ts), torch.as_tensor(padded), counts)


def valid_mask(x: RegularInTime):
    """(Nt, max_n) boolean mask of the genuine (not padding) entries."""
    return torch.arange(x.max_n)[None, :] < torch.as_tensor(x.counts)[:, None]


def get_times(x):
    if isinstance(x, RectilinearGrid):
        return x.xr
    if isinstance(x, RegularInTime):
        return x.ts
    return x


def n_time(x) -> int:
    return num_times(get_times(x))


def n_space(x) -> int:
    if isinstance(x, RectilinearGrid):
        return x.xl.shape[0]
    if isinstance(x, RegularInTime):
        return x.max_n
    return 1


def _ragged_indices(x: RegularInTime):
    """(row, column) of each flat observation in the padded (Nt, max_n)
    layout, from the counts."""
    counts = np.asarray(x.counts)
    rows = np.repeat(np.arange(counts.shape[0]), counts)
    cols = np.concatenate([np.arange(c) for c in counts])
    return torch.as_tensor(rows), torch.as_tensor(cols)


def observations_to_time_form(x, y):
    """Flat y (any array-like) -> per-time blocks (Nt, Ns); a RegularInTime
    pads with NaN (missing)."""
    y = torch.as_tensor(y)
    if isinstance(x, RectilinearGrid):
        return y.reshape(n_time(x), n_space(x))
    if isinstance(x, RegularInTime):
        rows, cols = _ragged_indices(x)
        out = y.new_full((n_time(x), x.max_n), float("nan"))
        out[rows.to(y.device), cols.to(y.device)] = y
        return out
    return y


def noise_var_to_time_form(x, noise_flat):
    """Flat per-observation variances -> per-time blocks (Nt, Ns); a
    RegularInTime's padding takes unit variance (it is always missing)."""
    noise_flat = torch.as_tensor(noise_flat)
    if isinstance(x, RectilinearGrid):
        return noise_flat.reshape(n_time(x), n_space(x))
    if isinstance(x, RegularInTime):
        rows, cols = _ragged_indices(x)
        out = noise_flat.new_ones((n_time(x), x.max_n))
        out[rows.to(out.device), cols.to(out.device)] = noise_flat
        return out
    return noise_flat


def destructure(x, ys):
    """Per-time blocks -> the flat vector."""
    ys = torch.as_tensor(ys)
    if isinstance(x, RectilinearGrid):
        return ys.reshape(-1)
    if isinstance(x, RegularInTime):
        rows, cols = _ragged_indices(x)
        return ys[rows.to(ys.device), cols.to(ys.device)]
    return ys


def flat_len(x) -> int:
    if isinstance(x, RectilinearGrid):
        return n_time(x) * n_space(x)
    if isinstance(x, RegularInTime):
        return int(sum(x.counts))
    return num_times(x)
