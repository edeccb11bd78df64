"""to_sde and the kernel -> LGSSM compiler (temporalgps_tpu/gp/lti_sde.py).

A `GP` wrapped by `to_sde` becomes an `LTISDE`; calling it on inputs with
observation noise gives a `FiniteLTISDE`; `build_lgssm` compiles kernel and
inputs into the `LGSSM` on which inference runs; `logpdf` and the prior
`marginals` run on it. `RegularSpacing` inputs give
one shared (A, Q) wrapped in `Fill`s; an (N,) tensor of times gives
per-step transitions.

The storage dtype and the device are explicit per model. The device is the
CUDA card unless the caller asks for the CPU: `to_sde(f, ArrayStorage(
torch.float32))` puts every tensor of the model on "cuda", `to_sde(f,
device="cpu")` on the CPU. Nothing is detected and nothing falls back: with
the default and no card, building the model raises PyTorch's own error.
"""

import dataclasses
from typing import Any

import torch

from ..config import DEFAULT_NOISE
from ..models import lgssm as lgssm_mod
from ..models import missings
from ..models.emissions import ScalarEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..utils.fill import Fill, is_fill
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from ..utils.regular_spacing import RegularSpacing, num_times
from . import kernels as K
from .means import ConstMean, ZeroMean


@dataclasses.dataclass(frozen=True)
class ArrayStorage:
    """Storage tag; its only payload is the dtype of the model's tensors."""

    dtype: torch.dtype = torch.float64


def _storage_dtype(storage):
    if storage is None:
        return torch.float64
    if isinstance(storage, ArrayStorage):
        return storage.dtype
    return storage  # a raw torch dtype


@dataclasses.dataclass(frozen=True, eq=False)
class GP:
    kernel: Any
    mean: Any = ZeroMean()


@dataclasses.dataclass(frozen=True, eq=False)
class LTISDE:
    """A GP marked for state-space inference, with its storage and device."""

    f: GP
    storage: ArrayStorage = ArrayStorage()
    device: torch.device = torch.device("cuda")

    def __call__(self, x, noise=None):
        dtype = _storage_dtype(self.storage)
        return FiniteLTISDE(self, x, _canon_noise(noise, x, dtype, self.device))


def to_sde(f: GP, storage=None, *, device="cuda") -> LTISDE:
    return LTISDE(f, storage if storage is not None else ArrayStorage(),
                  torch.device(device))


def _canon_noise(noise, x, dtype, device):
    """Per-observation variance: a Fill for scalar noise, (N,) otherwise."""
    N = num_times(x)
    if noise is None:
        return Fill(torch.tensor(DEFAULT_NOISE, dtype=dtype, device=device), N)
    if is_fill(noise):
        return noise
    noise = torch.as_tensor(noise, dtype=dtype, device=device)
    if noise.ndim == 0:
        return Fill(noise, N)
    return noise


@dataclasses.dataclass(frozen=True, eq=False)
class FiniteLTISDE:
    f: LTISDE
    x: Any      # RegularSpacing or (N,) tensor of times
    noise: Any  # Fill or (N,) tensor

    def __len__(self):
        return num_times(self.x)


def broadcast_components(atoms: K.SDEAtoms, x, dtype, device):
    """Discretise the SDE over the time grid.

    Q = P_inf - A P_inf A^T cancels catastrophically at small dt, so A and Q
    are always evaluated in float64 and then cast to the storage dtype, as in
    the reference."""
    hi = torch.float64
    P = symmetrize(atoms.P_inf).to(hi)
    D = P.shape[-1]
    N = num_times(x)
    if isinstance(x, RegularSpacing):
        A = atoms.transition(torch.as_tensor(x.dt, dtype=hi, device=device)).to(hi)
        Q = symmetrize(P - A @ P @ A.T)
        As = Fill(A.to(dtype), N)
        Qs = Fill(Q.to(dtype), N)
    else:
        t = torch.as_tensor(x, dtype=hi, device=device)
        # A first step of dt = 1: by stationarity any first dt gives the same
        # first marginal.
        dts = torch.cat([torch.ones(1, dtype=hi, device=device), torch.diff(t)])
        As_hi = atoms.transition(dts).to(hi)
        Qs = symmetrize(P - As_hi @ P @ As_hi.transpose(-1, -2)).to(dtype)
        As = As_hi.to(dtype)
    offs = Fill(torch.zeros(D, dtype=dtype, device=device), N)
    Hs = Fill(atoms.H.to(dtype), N)
    hs = Fill(torch.zeros((), dtype=dtype, device=device), N)
    return As, offs, Qs, Hs, hs


def _map_fill(fn, leaf):
    return Fill(fn(leaf.value), leaf.N)


def lgssm_components(kernel, x, dtype, device):
    """Recursive kernel compiler -> (As, offs, Qs, (Hs, hs), x0). The
    emission leaves Hs, hs are always Fills."""
    if isinstance(kernel, K.Scaled):
        As, offs, Qs, (Hs, hs), x0 = lgssm_components(kernel.kernel, x, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(kernel.sigma2, dtype=dtype, device=device))
        return As, offs, Qs, (_map_fill(lambda H: sigma * H, Hs),
                              _map_fill(lambda h: sigma * h, hs)), x0
    if isinstance(kernel, K.Stretched):
        # The stretch is applied to the times in the storage dtype, before
        # the float64 discretisation, as in the reference.
        s = torch.as_tensor(kernel.s, dtype=dtype, device=device)
        x_st = (
            x.stretch(s)
            if isinstance(x, RegularSpacing)
            else s * torch.as_tensor(x, dtype=dtype, device=device)
        )
        return lgssm_components(kernel.kernel, x_st, dtype, device)
    # Atoms are built in float64; broadcast_components applies the storage dtype.
    atoms = K.sde_atoms(kernel, torch.float64, device)
    As, offs, Qs, Hs, hs = broadcast_components(atoms, x, dtype, device)
    D = atoms.P_inf.shape[-1]
    x0 = Gaussian(
        torch.zeros(D, dtype=dtype, device=device),
        symmetrize(atoms.P_inf).to(dtype),
    )
    return As, offs, Qs, (Hs, hs), x0


def _add_mean_to_hs(hs, mean_fn, dtype, device):
    """Fold the GP mean into the emission offsets."""
    if isinstance(mean_fn, ZeroMean):
        return hs
    if isinstance(mean_fn, ConstMean):
        c = torch.as_tensor(mean_fn.c, dtype=dtype, device=device)
        return _map_fill(lambda h: h + c, hs)
    raise NotImplementedError(
        f"{type(mean_fn).__name__} is not ported yet (ROADMAP Queue 1 item 2)"
    )


def build_lgssm(fx: FiniteLTISDE) -> LGSSM:
    f = fx.f
    dtype = _storage_dtype(f.storage)
    As, offs, Qs, (Hs, hs), x0 = lgssm_components(f.f.kernel, fx.x, dtype, f.device)
    hs = _add_mean_to_hs(hs, f.f.mean, dtype, f.device)
    return LGSSM(
        GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x0, forward=True),
        ScalarEmissions(H=Hs, h=hs, s=fx.noise),
    )


def logpdf(fx: FiniteLTISDE, y, *, engine=None, **engine_kwargs):
    """Log marginal likelihood of y under fx; NaNs in y are missing
    observations. `engine=None` picks the fused block engine for a supported
    model on a CUDA device and the sequential engine otherwise;
    `engine_kwargs` (`fused`, `n_blocks`) go to models.lgssm.logpdf."""
    model = build_lgssm(fx)
    y = torch.as_tensor(y, dtype=model.dtype, device=model.device)
    return missings.logpdf_with_missings(model, y, engine=engine, **engine_kwargs)


def marginals(fx: FiniteLTISDE, *, engine=None):
    """Prior marginal (means, variances) of every observation, the noise
    included. `engine=None` runs the affine block schedule (K8-K10) for a
    model on a CUDA device and the sequential engine otherwise."""
    return lgssm_mod.marginals_diag(build_lgssm(fx), engine=engine)


def mean_and_var(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)


def mean(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)[0]


def var(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)[1]
