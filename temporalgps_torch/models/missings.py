"""Missing data (temporalgps_tpu/models/missings.py).

A NaN in y is a missing observation: its noise becomes LARGE_VAR, its value
0, and the log marginal likelihood gets the volume compensation
n_missing * log(2 pi LARGE_VAR) / 2 back. Shapes stay static.
"""

import math

import torch

from ..config import LARGE_VAR
from ..utils.fill import tmaterialize
from . import emissions as em
from .lgssm import LGSSM, filter_, logpdf, posterior

_HALF_LOG_2PI_LARGE_VAR = 0.5 * math.log(2.0 * math.pi * LARGE_VAR)


def fill_in_missings(noise, y):
    """(noise_filled, y_filled, n_missing). `noise` is the per-step noise
    leaf: (N,) scalar variances or (N, Dout) diagonals, which take LARGE_VAR
    where y is NaN, or (N, Dout, Dout) dense covariances, whose diagonal
    takes LARGE_VAR at a missing entry and whose row and column of it
    become zero off the diagonal."""
    mask = torch.isnan(y)
    y_filled = torch.where(mask, 0.0, y)
    if noise.ndim == y.ndim:
        noise_filled = torch.where(mask, LARGE_VAR, noise)
    else:
        keep = ~mask[..., :, None] & ~mask[..., None, :]
        diag = torch.where(mask, LARGE_VAR, torch.diagonal(noise, dim1=-2, dim2=-1))
        eye = torch.eye(noise.shape[-1], dtype=torch.bool, device=noise.device)
        noise_filled = torch.where(eye, torch.diag_embed(diag), torch.where(keep, noise, 0.0))
    return noise_filled, y_filled, mask.sum()


def volume_compensation(n_missing, dtype):
    """What n_missing filled observations take from the lml, to add back."""
    return n_missing.to(dtype) * _HALF_LOG_2PI_LARGE_VAR


def replace_observation_noise_cov(model: LGSSM, new_noise) -> LGSSM:
    """The model with its per-step observation noise leaf swapped."""
    return LGSSM(model.trans, em.replace_noise_cov(model.emis, new_noise))


def transform_model_and_obs(model: LGSSM, y):
    """(model', y', compensation) with the missing entries marginalised out.
    Only the noise leaf is materialised; the other leaves stay Fills."""
    noise = tmaterialize(em.noise_cov(model.emis))
    noise_filled, y_filled, n_missing = fill_in_missings(noise, y)
    comp = volume_compensation(n_missing, y_filled.dtype)
    return replace_observation_noise_cov(model, noise_filled), y_filled, comp


def logpdf_with_missings(model: LGSSM, y, *, engine=None, nan_fallback=True, **engine_kwargs):
    """The lml of y with NaNs for the missing observations. engine="lti" and
    "steady" take no missing data (the large-variance fill makes the noise
    leaf per step): they run on y as it is, and a NaN in it raises
    ValueError. The reference, under jit, falls back to the block engine's
    missing-data path instead; the port is eager, its y always concrete, so
    `nan_fallback` (kept for the signature) never acts."""
    if engine in ("lti", "steady"):
        if bool(torch.isnan(torch.as_tensor(y)).any()):
            raise ValueError(f"engine={engine!r} requires fully-observed data (no NaNs); "
                             "use engine='block'/'sequential' for missing data")
        return logpdf(model, y, engine=engine, **engine_kwargs)
    model_f, y_f, comp = transform_model_and_obs(model, y)
    return logpdf(model_f, y_f, engine=engine, **engine_kwargs) + comp


def posterior_with_missings(model: LGSSM, y, *, engine=None, **engine_kwargs):
    """The smoothing posterior (models.lgssm.posterior) given y with NaNs for
    the missing observations."""
    model_f, y_f, _ = transform_model_and_obs(model, y)
    return posterior(model_f, y_f, engine=engine, **engine_kwargs)


def filter_with_missings(model: LGSSM, y, *, engine=None, **engine_kwargs):
    """The filtering distributions (models.lgssm.filter_) given y with NaNs
    for the missing observations."""
    model_f, y_f, _ = transform_model_and_obs(model, y)
    return filter_(model_f, y_f, engine=engine, **engine_kwargs)
