"""Missing data (temporalgps_tpu/models/missings.py).

A NaN in y is a missing observation: its noise becomes LARGE_VAR, its value
0, and the log marginal likelihood gets the volume compensation
n_missing * log(2 pi LARGE_VAR) / 2 back. Shapes stay static.
"""

import dataclasses
import math

import torch

from ..config import LARGE_VAR
from ..utils.fill import is_fill
from .lgssm import LGSSM, logpdf

_HALF_LOG_2PI_LARGE_VAR = 0.5 * math.log(2.0 * math.pi * LARGE_VAR)


def fill_in_missings(noise, y):
    """(noise_filled, y_filled, n_missing) for (N,) scalar noise variances."""
    mask = torch.isnan(y)
    y_filled = torch.where(mask, 0.0, y)
    noise_filled = torch.where(mask, LARGE_VAR, noise)
    return noise_filled, y_filled, mask.sum()


def volume_compensation(n_missing, dtype):
    """What n_missing filled observations take from the lml, to add back."""
    return n_missing.to(dtype) * _HALF_LOG_2PI_LARGE_VAR


def transform_model_and_obs(model: LGSSM, y):
    """(model', y', compensation) with the missing entries marginalised out.
    Only the noise leaf is materialised; the other leaves stay Fills."""
    noise = model.emis.s
    if is_fill(noise):
        noise = noise.value.expand(noise.N)
    noise_filled, y_filled, n_missing = fill_in_missings(noise, y)
    comp = volume_compensation(n_missing, y_filled.dtype)
    emis = dataclasses.replace(model.emis, s=noise_filled)
    return LGSSM(model.trans, emis), y_filled, comp


def logpdf_with_missings(model: LGSSM, y, *, engine=None, **engine_kwargs):
    model_f, y_f, comp = transform_model_and_obs(model, y)
    return logpdf(model_f, y_f, engine=engine, **engine_kwargs) + comp
