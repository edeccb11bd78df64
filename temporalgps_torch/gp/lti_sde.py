"""to_sde and the kernel -> LGSSM compiler (temporalgps_tpu/gp/lti_sde.py).

A `GP` wrapped by `to_sde` becomes an `LTISDE`; calling it on inputs with
observation noise gives a `FiniteLTISDE`; `build_lgssm` compiles kernel and
inputs into the `LGSSM` on which inference runs; `logpdf` and the prior
`marginals` and `rand` run on it. `RegularSpacing` inputs give
one shared (A, Q) wrapped in `Fill`s; an (N,) tensor of times gives
per-step transitions. A Sum kernel compiles to the direct sum of its
children's chains (block-diagonal A, Q and x0 covariance, concatenated H,
summed h); a CustomMean to a per-step emission offset h. A Separable kernel
on a RectilinearGrid (space_time/) compiles to the space-time LGSSM of
space_time/builder.py; `logpdf`, `marginals` and `rand` take and give flat
(space-fastest) observations for it, and with engine="kron" run the
factored engine of space_time/kron.py on it instead (_route_kron). A
kernel with a deterministic summand (Cosine, Constant, ApproxPeriodic) and
a stochastic one scores on the basis engine (ops/basis.py, `basis_setup`):
the deterministic summands as basis functions marginalised against the
reduced stochastic model.

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
from ..utils import psd
from ..utils.fill import Fill, is_fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from ..space_time import grids
from ..utils.regular_spacing import RegularSpacing, num_times, time_array
from . import kernels as K
from .means import ConstMean, ZeroMean, mean_vector


@dataclasses.dataclass(frozen=True)
class ArrayStorage:
    """Storage tag; its only payload is the dtype of the model's tensors."""

    dtype: torch.dtype = torch.float64


@dataclasses.dataclass(frozen=True)
class SArrayStorage:
    """The reference's static-array storage tag; the same as ArrayStorage
    here (its only payload is the dtype), kept for API parity."""

    dtype: torch.dtype = torch.float64


def _storage_dtype(storage):
    if storage is None:
        return torch.float64
    if isinstance(storage, (ArrayStorage, SArrayStorage)):
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
    N = _flat_len(x)
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
    x: Any      # RegularSpacing, (N,) tensor of times or RectilinearGrid
    noise: Any  # Fill or (N,) tensor, one variance per (flat) observation

    def __len__(self):
        return _flat_len(self.x)


def _is_grid(x) -> bool:
    return isinstance(x, (grids.RectilinearGrid, grids.RegularInTime))


def _flat_len(x) -> int:
    return grids.flat_len(x) if _is_grid(x) else num_times(x)


def _to_time_form(x, y):
    return grids.observations_to_time_form(x, y) if _is_grid(x) else y


def _destructure(x, ys):
    return grids.destructure(x, ys) if _is_grid(x) else ys


def broadcast_components(atoms: K.SDEAtoms, x, dtype, device, det=False):
    """Discretise the SDE over the time grid.

    Q = P_inf - A P_inf A^T cancels catastrophically at small dt, so A and Q
    are always evaluated in float64 and then cast to the storage dtype, as in
    the reference. `det` marks a leaf with a deterministic component (its
    Q vanishes on those blocks, to rounding): in float32 storage its Q is
    floored at 1e-5 P_inf, as the reference's, so that the filter's
    round-off along those blocks (~1e-7 |P| a step, nothing to damp it)
    does not drive the covariance indefinite; float64 takes no floor."""
    hi = torch.float64
    P = symmetrize(atoms.P_inf).to(hi)
    D = P.shape[-1]
    N = num_times(x)
    q_floor = 1e-5 if det and torch.finfo(dtype).bits < 64 else 0.0
    if isinstance(x, RegularSpacing):
        A = atoms.transition(torch.as_tensor(x.dt, dtype=hi, device=device)).to(hi)
        Q = symmetrize(P - A @ P @ A.T) + q_floor * P
        As = Fill(A.to(dtype), N)
        Qs = Fill(Q.to(dtype), N)
    else:
        t = torch.as_tensor(x, dtype=hi, device=device)
        # A first step of dt = 1: by stationarity any first dt gives the same
        # first marginal.
        dts = torch.cat([torch.ones(1, dtype=hi, device=device), torch.diff(t)])
        As_hi = atoms.transition(dts).to(hi)
        Qs = (symmetrize(P - As_hi @ P @ As_hi.transpose(-1, -2)) + q_floor * P).to(dtype)
        As = As_hi.to(dtype)
    offs = Fill(torch.zeros(D, dtype=dtype, device=device), N)
    Hs = Fill(atoms.H.to(dtype), N)
    hs = Fill(torch.zeros((), dtype=dtype, device=device), N)
    return As, offs, Qs, Hs, hs


def _combine_leaves(fn, leaves, N):
    """fn over per-step leaves: a Fill when every leaf is one, else fn on the
    leaves with a leading time axis (a Fill broadcast to it), for `fn`
    batched over leading axes."""
    if all(is_fill(leaf) for leaf in leaves):
        return Fill(fn(*(leaf.value for leaf in leaves)), N)
    return fn(*(tmaterialize(leaf) for leaf in leaves))


def _block_diag(*mats):
    return psd.block_diag(list(mats))


def _concat(*vecs):
    return torch.cat(vecs, dim=-1)


def lgssm_components(kernel, x, dtype, device):
    """Recursive kernel compiler -> (As, offs, Qs, (Hs, hs), x0). The
    emission leaves Hs, hs are Fills; a Sum's transition leaves are per step
    when any child's are."""
    N = num_times(x)
    if isinstance(kernel, K.Sum):
        parts = [lgssm_components(c, x, dtype, device) for c in kernel.kernels]
        leaves = lambda i: [p[i] for p in parts]
        As = _combine_leaves(_block_diag, leaves(0), N)
        offs = _combine_leaves(_concat, leaves(1), N)
        Qs = _combine_leaves(_block_diag, leaves(2), N)
        Hs = _combine_leaves(_concat, [p[3][0] for p in parts], N)
        hs = _combine_leaves(lambda *hs: sum(hs), [p[3][1] for p in parts], N)
        x0 = Gaussian(torch.cat([p[4].mean for p in parts], dim=-1),
                      psd.block_diag([p[4].cov for p in parts]))
        return As, offs, Qs, (Hs, hs), x0
    if isinstance(kernel, K.Scaled):
        As, offs, Qs, (Hs, hs), x0 = lgssm_components(kernel.kernel, x, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(kernel.sigma2, dtype=dtype, device=device))
        return As, offs, Qs, (_combine_leaves(lambda H: sigma * H, [Hs], N),
                              _combine_leaves(lambda h: sigma * h, [hs], N)), x0
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
    As, offs, Qs, Hs, hs = broadcast_components(atoms, x, dtype, device,
                                                det=K.has_deterministic_component(kernel))
    D = atoms.P_inf.shape[-1]
    x0 = Gaussian(
        torch.zeros(D, dtype=dtype, device=device),
        symmetrize(atoms.P_inf).to(dtype),
    )
    return As, offs, Qs, (Hs, hs), x0


def _add_mean_to_hs(hs, mean_fn, x, dtype, device):
    """Fold the GP mean into the emission offsets: a constant one stays a
    Fill, a CustomMean gives an (N,) h, the function evaluated on the times
    (in their own dtype, then cast to the storage dtype)."""
    if isinstance(mean_fn, ZeroMean):
        return hs
    if isinstance(mean_fn, ConstMean):
        c = torch.as_tensor(mean_fn.c, dtype=dtype, device=device)
        return _combine_leaves(lambda h: h + c, [hs], num_times(x))
    m = mean_vector(mean_fn, time_array(x, device)).to(dtype)
    return tmaterialize(hs) + m


def build_lgssm(fx: FiniteLTISDE) -> LGSSM:
    if _is_grid(fx.x):
        from ..space_time import builder

        return builder.build_lgssm_spacetime(fx)
    f = fx.f
    dtype = _storage_dtype(f.storage)
    As, offs, Qs, (Hs, hs), x0 = lgssm_components(f.f.kernel, fx.x, dtype, f.device)
    hs = _add_mean_to_hs(hs, f.f.mean, fx.x, dtype, f.device)
    return LGSSM(
        GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x0, forward=True,
                    det_blocks=K.has_deterministic_component(f.f.kernel)),
        ScalarEmissions(H=Hs, h=hs, s=fx.noise),
    )


def _route_kron(fx, engine, verb) -> bool:
    """Whether `verb` ("logpdf", "marginals", "rand" or "posterior") takes
    the factored space-time engine (space_time/kron.py). engine="kron"
    forces it, and raises TypeError for a model it does not take;
    engine=None takes it for a supported grid model on a CUDA device where
    kron.takes_engine_none says (the card's rule, measured there), never on
    the CPU."""
    from ..space_time import kron

    if engine == "kron":
        if not kron.supports(fx):
            raise TypeError("engine='kron' requires a (possibly Scaled) Separable model "
                            "on a RectilinearGrid")
        return True
    return (engine is None and _is_grid(fx.x) and fx.f.device.type == "cuda"
            and kron.supports(fx) and kron.takes_engine_none(fx, verb))


def basis_setup(fx: FiniteLTISDE):
    """The basis engine's front end (ops/basis.py): (model, M, P0), the
    LGSSM of the kernel's stochastic summands, the basis columns M (N, d)
    of its deterministic summands at tau = t - t[0] and their weights'
    prior covariance P0 (d, d), M and P0 in the storage dtype. tau and the
    columns are formed in float64 and then cast: a float32 time axis at
    N = 1M would put cos(2 pi 6 t) off by ~1e-3. M and P0 are None for a
    kernel with no deterministic summand (the model is then fx's own).
    Raises TypeError for a grid's inputs and for a purely deterministic
    kernel."""
    if _is_grid(fx.x):
        raise TypeError("engine='basis' supports time-series inputs only")
    f = fx.f
    dtype, device = _storage_dtype(f.storage), f.device
    stoch, det = K.split_deterministic(f.f.kernel)
    if not det:
        return build_lgssm(fx), None, None
    if not stoch:
        raise TypeError(
            "engine='basis' needs at least one stochastic summand; a purely deterministic "
            "kernel has a singular prior: add observation noise to the model instead "
            "(engine='sequential')")
    k_stoch = stoch[0] if len(stoch) == 1 else K.Sum(tuple(stoch))
    model = build_lgssm(FiniteLTISDE(LTISDE(GP(k_stoch, f.f.mean), f.storage, device), fx.x,
                                     fx.noise))
    t = time_array(fx.x, device).to(torch.float64)
    cols = [K.det_basis_columns(kd, t - t[0], torch.float64, device) for kd in det]
    M = torch.cat([c[0] for c in cols], dim=-1).to(dtype)
    P0 = psd.block_diag([c[1] for c in cols]).to(dtype)
    return model, M, P0


def _logpdf_basis(fx: FiniteLTISDE, y, *, sub_engine=None, n_blocks=None, n_warmup=None,
                  fwd_mode=False):
    """The lml on the basis engine (ops/basis.py) on `sub_engine`
    ("sequential", "block", the default, or "steady"). NaNs in y are missing
    observations: the large-variance fill of the reduced model zeroes every
    column's innovation at a missing step, and the volume compensation
    applies unchanged. "steady" runs on the Fill model as it is and takes
    no missing data: a NaN raises ValueError (the port's y is always
    concrete, so the reference's traced-NaN fallback and its `nan_fallback`
    option have no counterpart). `fwd_mode=True` bypasses the steady late
    segment's autograd.Function, for forward-mode gradients."""
    from ..ops import basis

    model, M, P0 = basis_setup(fx)
    y = torch.as_tensor(y, dtype=model.dtype, device=model.device)
    if M is None:  # no deterministic part
        return missings.logpdf_with_missings(model, y, engine=sub_engine)
    w_off = torch.zeros(M.shape[-1] + 1, dtype=model.dtype, device=model.device)
    w_off[0] = 1.0

    def lml(model_, y_, engine):
        return basis.logpdf_basis(model_, torch.cat([y_[:, None], M], dim=-1), w_off, P0,
                                  engine=engine, n_blocks=n_blocks, n_warmup=n_warmup,
                                  fwd_mode=fwd_mode)

    if sub_engine == "steady":
        if bool(torch.isnan(y).any()):
            raise ValueError("sub_engine='steady' requires fully-observed data (no NaNs); "
                             "use sub_engine='block' for missing data")
        return lml(model, y, "steady")
    model_f, y_f, comp = missings.transform_model_and_obs(model, y)
    return lml(model_f, y_f, sub_engine or "block") + comp


def _takes_basis(fx, engine) -> bool:
    """engine="basis", or engine=None for a time series whose kernel has a
    deterministic summand and a stochastic one, as the reference routes."""
    if engine == "basis":
        return True
    if engine is not None or _is_grid(fx.x):
        return False
    kern = fx.f.f.kernel
    return K.has_deterministic_component(kern) and bool(K.split_deterministic(kern)[0])


def logpdf(fx: FiniteLTISDE, y, *, engine=None, **engine_kwargs):
    """Log marginal likelihood of y under fx; NaNs in y are missing
    observations. `engine=None` takes the basis engine for a time series
    whose kernel has a deterministic summand and a stochastic one
    (`_logpdf_basis`: the exact lml without the deterministic blocks in the
    filter; `sub_engine`, `n_warmup`, `fwd_mode` go there), as
    engine="basis" does; otherwise, for a model on a CUDA device, the block
    engine where its kernels take the model and the parallel one above D = 3,
    for a grid's model there the kron engine or the parallel one
    (_route_kron, models.lgssm._resolve_engine), and the sequential engine
    otherwise; `engine_kwargs` (`fused`, `n_blocks`) go to
    models.lgssm.logpdf. On a grid, y is flat (space fastest);
    engine="kron" runs the factored engine (space_time/kron.py) on it."""
    if _takes_basis(fx, engine):
        return _logpdf_basis(fx, y, **engine_kwargs)
    if _route_kron(fx, engine, "logpdf"):
        from ..space_time import kron

        return kron.logpdf(fx, y)
    model = build_lgssm(fx)
    y = _to_time_form(fx.x, torch.as_tensor(y, dtype=model.dtype, device=model.device))
    return missings.logpdf_with_missings(model, y, engine=engine, **engine_kwargs)


def rand(generator, fx: FiniteLTISDE, n=None, *, engine=None):
    """A joint prior sample of the observations, noise included; `n` draws
    stacked on a leading axis. The normals come from `generator`, a
    torch.Generator on the model's device (the reference takes a key).
    `engine=None` runs the affine block schedule (K8-K10 with zero process
    noise rows) for a model on a CUDA device (a grid's: the parallel
    engine; engine="kron" the factored one), the sequential engine
    otherwise."""
    if _route_kron(fx, engine, "rand"):
        from ..space_time import kron

        return kron.rand(generator, fx, n).flatten(-2)  # flat per draw, space fastest
    model = build_lgssm(fx)
    draw = lambda: _destructure(fx.x, lgssm_mod.rand(generator, model, engine=engine))
    return draw() if n is None else torch.stack([draw() for _ in range(n)])


def cov(fx: FiniteLTISDE):
    """The dense prior covariance of the observations, O(N^2), as the
    reference's: the kernel's gram at the times plus the noise."""
    t = time_array(fx.x, fx.f.device).to(_storage_dtype(fx.f.storage))
    return K.gram(fx.f.f.kernel, t) + torch.diag(tmaterialize(fx.noise))


def marginals(fx: FiniteLTISDE, *, engine=None):
    """Prior marginal (means, variances) of every observation, the noise
    included. `engine=None` runs the affine block schedule (K8-K10) for a
    model on a CUDA device (a grid's: the parallel engine; engine="kron"
    the factored one) and the sequential engine otherwise."""
    if _route_kron(fx, engine, "marginals"):
        from ..space_time import kron

        m, v = kron.marginals(fx)
        return _destructure(fx.x, m), _destructure(fx.x, v)
    m, v = lgssm_mod.marginals_diag(build_lgssm(fx), engine=engine)
    return _destructure(fx.x, m), _destructure(fx.x, v)


def mean_and_var(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)


def mean(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)[0]


def var(fx: FiniteLTISDE, *, engine=None):
    return marginals(fx, engine=engine)[1]
