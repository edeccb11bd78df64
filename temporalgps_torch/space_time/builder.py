"""The space-time LGSSM builder: a grid's (or a RegularInTime's)
FiniteLTISDE -> LGSSM (temporalgps_tpu/space_time/builder.py)."""

import torch

from ..gp import kernels as K
from ..gp.lti_sde import _combine_leaves, _storage_dtype
from ..gp.means import ConstMean, ZeroMean
from ..models.emissions import DenseEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..utils.fill import Fill, is_fill
from . import grids
from .pseudo_point import build_dtc_lgssm, contains_dtc
from .to_gauss_markov import lgssm_components_spacetime


def build_lgssm_spacetime(fx) -> LGSSM:
    """The exact space-time LGSSM of fx, with DenseEmissions: per time step
    the Ns observations of the grid, their noise the diagonal covariance of
    the per-observation variances. Homoscedastic noise on a grid stays a
    per-time Fill, so every emission leaf of a regular grid is constant.
    Mean functions: ZeroMean and ConstMean. A kernel with a DTCSeparable
    (space_time/pseudo_point.py) builds the pseudo-point LGSSM with
    BottleneckEmissions instead, on a grid or a RegularInTime."""
    f = fx.f
    dtype, device = _storage_dtype(f.storage), f.device
    x = fx.x
    Nt = grids.n_time(x)
    noise = fx.noise
    if is_fill(noise) and noise.value.ndim == 0 and isinstance(x, grids.RectilinearGrid):
        noise_tf = Fill(noise.value.to(dtype).expand(grids.n_space(x)), Nt)
    else:
        flat = noise.value.expand(noise.N) if is_fill(noise) else noise
        noise_tf = grids.noise_var_to_time_form(x, flat)  # (Nt, Ns)

    if contains_dtc(f.f.kernel):
        return build_dtc_lgssm(f.f.kernel, x, noise_tf, f.f.mean, dtype, device)
    As, offs, Qs, (Hs, hs), x0 = lgssm_components_spacetime(f.f.kernel, x, dtype, device)
    mean_fn = f.f.mean
    if isinstance(mean_fn, ConstMean):
        c = torch.as_tensor(mean_fn.c, dtype=dtype, device=device)
        hs = _combine_leaves(lambda h: h + c, [hs], Nt)
    elif not isinstance(mean_fn, ZeroMean):
        raise NotImplementedError(
            "spatio-temporal models support ZeroMean/ConstMean mean functions")
    S = _combine_leaves(torch.diag_embed, [noise_tf], Nt)
    return LGSSM(GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x0, forward=True,
                             det_blocks=_temporal_det(f.f.kernel)),
                 DenseEmissions(H=Hs, h=hs, S=S))


def _temporal_det(kernel) -> bool:
    """Whether the temporal part of a space-time kernel tree has a
    deterministic component (gp.kernels.has_deterministic_component)."""
    from .pseudo_point import DTCSeparable
    from .separable import Separable

    if isinstance(kernel, (Separable, DTCSeparable)):
        sep = kernel.k if isinstance(kernel, DTCSeparable) else kernel
        return K.has_deterministic_component(sep.r)
    if isinstance(kernel, K.Scaled):
        return _temporal_det(kernel.kernel)
    if isinstance(kernel, (K.Sum, K.Product)):
        return any(_temporal_det(c) for c in kernel.kernels)
    return False
