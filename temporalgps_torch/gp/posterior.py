"""PosteriorLTISDE — the exact posterior GP of a time series, predicted
through the state-space smoother (temporalgps_tpu/gp/posterior.py, the 1-D
time-series half).

A posterior is kept lazily as (prior, y, x, noise). At the training inputs
its marginals are the smoothing posterior's: the filter and the reversed
dynamics (models.lgssm.posterior), then the marginals of the reverse chain
with the prediction noise in place of the training noise. At new inputs the
training and prediction times are merged and sorted on the host (numpy),
the prediction points are marked missing, the same pipeline runs on the
merged model, and the prediction indices are read out.

Routes: on the card, the posterior at the training inputs of a
RegularSpacing model runs on K1, K2, K7 and the marginals on K8-K10. At new
inputs (or irregular training times) the merged times are irregular, so
the model has per-step transitions: its filter runs on the streamed forms
of K1 and K7 (each step's (A, a, Q) read from a row stream) with K2, and
its marginals on K8-K10. Models of more than three states take the block
engine's plain matrix path. The dense posterior covariance is refused, as
in the reference.

Grids (space_time/): a RectilinearGrid posterior merges along time only (the
spatial points must agree) and indexes the flat (space-fastest) vectors;
its model has D = Ns * Dt states and vector emissions, so it takes the
matrix path, or with engine="kron" (on the card by default where
space_time.kron.takes_engine_none says) the factored smoother of
space_time/kron.py for `marginals`. RegularInTime inputs are refused, as in
the reference's exact inference: they take the pseudo-point verbs
(space_time/pseudo_point.py).

Sampling and scoring new data (`rand`, `logpdf`) always merge, as the
reference does, even at the training inputs (each time then appears twice:
a step of dt = 0 with A = I and Q = 0). `rand` samples the reverse-ordered
posterior LGSSM over the merged times on K8-K10 and reads out the
prediction indices; `logpdf` scores y at the prediction indices with NaN at
the training ones, the reverse model's filter on the streamed K1, K2 and
the streamed K3.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import LARGE_VAR
from ..models import emissions as em
from ..models import lgssm as lgssm_mod
from ..models import missings as missings_mod
from ..models.emissions import DenseEmissions, ScalarEmissions
from ..space_time import grids
from ..utils.fill import is_fill
from ..utils.regular_spacing import RegularSpacing, time_array
from .lti_sde import (LTISDE, FiniteLTISDE, _canon_noise, _destructure, _flat_len, _is_grid,
                      _route_kron, _storage_dtype, _to_time_form, build_lgssm)


@dataclasses.dataclass(frozen=True, eq=False)
class PosteriorLTISDE:
    prior: LTISDE
    y: torch.Tensor
    x: Any
    noise: Any

    def __call__(self, x_pr, noise=None):
        _check_inputs(x_pr)
        dtype = _storage_dtype(self.prior.storage)
        return FinitePosteriorLTISDE(self, x_pr, _canon_noise(noise, x_pr, dtype,
                                                               self.prior.device))


@dataclasses.dataclass(frozen=True, eq=False)
class FinitePosteriorLTISDE:
    f: PosteriorLTISDE
    x: Any
    noise: Any


def _check_inputs(x):
    """The inputs of exact inference: RegularSpacing, a vector of times or a
    RectilinearGrid (a RegularInTime takes the pseudo-point verbs, as the
    reference's exact compiler refuses it)."""
    if isinstance(x, grids.RegularInTime):
        raise TypeError(
            "exact inference takes no RegularInTime inputs: use the pseudo-point verbs "
            "(space_time.dtc, elbo, approx_posterior_marginals)")
    ndim = x.ndim if hasattr(x, "ndim") else np.ndim(x)
    if isinstance(x, (RegularSpacing, grids.RectilinearGrid)) or ndim == 1:
        return
    raise ValueError(f"inputs of {ndim} dimensions: exact inference takes RegularSpacing, "
                     "a vector of times or a RectilinearGrid")


def posterior(fx: FiniteLTISDE, y) -> PosteriorLTISDE:
    """The lazy posterior of fx given y (NaN = missing; flat on a grid)."""
    _check_inputs(fx.x)
    dtype = _storage_dtype(fx.f.storage)
    return PosteriorLTISDE(fx.f, torch.as_tensor(y, dtype=dtype, device=fx.f.device),
                           fx.x, fx.noise)


def _noise_array(noise, N):
    return noise.value.expand(N) if is_fill(noise) else noise


def _times_of(x):
    return time_array(grids.get_times(x)).detach().cpu().numpy()


def _same_points(x1, x2) -> bool:
    """Whether two grids have the same spatial points."""
    s1, s2 = (torch.as_tensor(x.xl).detach().cpu().numpy() for x in (x1, x2))
    return s1.shape == s2.shape and bool(np.all(s1 == s2))


def _same_inputs(x1, x2) -> bool:
    if x1 is x2:
        return True
    if _is_grid(x1) != _is_grid(x2) or (_is_grid(x1) and not _same_points(x1, x2)):
        return False
    t1, t2 = _times_of(x1), _times_of(x2)
    return t1.shape == t2.shape and bool(np.all(t1 == t2))


def _merge_order(fp: PosteriorLTISDE, x_pr):
    """(sorted times, rank of each training time, rank of each prediction
    time) of the merged inputs; host-side numpy."""
    t_tr, t_pr = _times_of(fp.x), _times_of(x_pr)
    t_all = np.concatenate([t_tr, t_pr])
    order = np.argsort(t_all, kind="stable")
    rank = np.argsort(order, kind="stable")
    return t_all[order], rank[:len(t_tr)], rank[len(t_tr):]


def _build_inference_data(fp: PosteriorLTISDE, x_pr):
    """Merged, time-sorted (x, noise, y with NaN at the prediction points,
    tr_idx, pr_idx), flat; on a grid the merge is along time only, the
    indices flat (space-fastest) positions."""
    t_sorted, tr_rank, pr_rank = _merge_order(fp, x_pr)
    device = fp.y.device
    if _is_grid(fp.x) or _is_grid(x_pr):
        if not (isinstance(fp.x, grids.RectilinearGrid)
                and isinstance(x_pr, grids.RectilinearGrid)):
            raise TypeError("grid posterior prediction requires RectilinearGrid inputs")
        if not _same_points(fp.x, x_pr):
            raise ValueError("Space coords of inputs not compatible, cannot merge.")
        Ns = fp.x.xl.shape[0]
        flat = lambda ranks: (ranks[:, None] * Ns + np.arange(Ns)).reshape(-1)
        tr_idx, pr_idx = flat(tr_rank), flat(pr_rank)
        x_sorted = grids.RectilinearGrid(fp.x.xl, torch.as_tensor(t_sorted, device=device))
    else:
        tr_idx, pr_idx = tr_rank, pr_rank
        x_sorted = torch.as_tensor(t_sorted, device=device)
    n = len(tr_idx) + len(pr_idx)
    tr_t = torch.as_tensor(tr_idx, device=device)
    noise_all = fp.y.new_full((n,), LARGE_VAR)
    noise_all[tr_t] = _noise_array(fp.noise, len(tr_idx)).to(fp.y.dtype)
    y_all = fp.y.new_full((n,), float("nan"))
    y_all[tr_t] = fp.y
    return x_sorted, noise_all, y_all, tr_idx, pr_idx


def _noise_leaf_like(model, x, noise_flat):
    """Flat noise in the representation of the model's emissions: dense
    per-time matrices for a grid's DenseEmissions, flat for scalar ones."""
    tf = _to_time_form(x, noise_flat)
    return torch.diag_embed(tf) if isinstance(model.emis, DenseEmissions) else tf


def _pred_noise_full(pr_idx, n, noise_pr, dtype, device):
    """Zeros at the training indices, the prediction noise at the prediction
    indices, flat."""
    out = torch.zeros(n, dtype=dtype, device=device)
    out[torch.as_tensor(pr_idx, device=device)] = _noise_array(noise_pr, len(pr_idx)).to(dtype)
    return out


def _posterior_model(fp, x, noise, y, noise_pred, *, engine=None):
    """The posterior LGSSM of the prior at x with noise, conditioned on the
    flat y, with the flat prediction noise in place of the training noise."""
    model = build_lgssm(fp.prior(x, noise))
    post = missings_mod.posterior_with_missings(model, _to_time_form(x, y), engine=engine)
    return missings_mod.replace_observation_noise_cov(post, _noise_leaf_like(model, x, noise_pred))


def _merged_data(fxp: FinitePosteriorLTISDE):
    """(merged inputs, their training noise, y with NaN at the prediction
    points, the prediction noise at the prediction indices and zero at the
    training ones, the prediction indices as a tensor on y's device), all
    flat: a merged grid's (Nt, Ns) outputs flattened, space fastest."""
    fp = fxp.f
    x_sorted, noise_all, y_all, _tr_idx, pr_idx = _build_inference_data(fp, fxp.x)
    noise_pred = _pred_noise_full(pr_idx, len(y_all), fxp.noise,
                                  _storage_dtype(fp.prior.storage), y_all.device)
    return x_sorted, noise_all, y_all, noise_pred, torch.as_tensor(pr_idx, device=y_all.device)


def _merged_posterior(fxp: FinitePosteriorLTISDE, engine):
    """(posterior LGSSM over the merged inputs, with the prediction noise at
    the prediction indices and zero at the training ones; the prediction
    indices into its flat outputs)."""
    x, noise, y, noise_pred, idx = _merged_data(fxp)
    return _posterior_model(fxp.f, x, noise, y, noise_pred, engine=engine), idx


def marginals(fxp: FinitePosteriorLTISDE, *, engine=None):
    """Posterior marginal (means, variances) at fxp.x, including the
    prediction noise fxp.noise; flat on a grid. A grid model that takes the
    factored engine (engine="kron", or engine=None by lti_sde._route_kron)
    runs its smoother (space_time/kron.py): at new times on the merged grid,
    whose prediction steps are whole rows of missing observations."""
    from ..space_time import kron

    fp = fxp.f
    if _same_inputs(fxp.x, fp.x):
        noise_pred = _noise_array(fxp.noise, _flat_len(fxp.x))
        fx = fp.prior(fp.x, fp.noise)
        if _route_kron(fx, engine, "posterior"):
            m, v = kron.posterior_marginals(
                fx, fp.y, noise_pred=grids.noise_var_to_time_form(fxp.x, noise_pred))
            return _destructure(fxp.x, m), _destructure(fxp.x, v)
        post = _posterior_model(fp, fp.x, fp.noise, fp.y, noise_pred, engine=engine)
        m, v = lgssm_mod.marginals_diag(post, engine=engine)
        return _destructure(fxp.x, m), _destructure(fxp.x, v)
    x, noise, y, noise_pred, idx = _merged_data(fxp)
    fx = fp.prior(x, noise)
    if _route_kron(fx, engine, "posterior"):
        m, v = kron.posterior_marginals(fx, y,
                                        noise_pred=grids.noise_var_to_time_form(x, noise_pred))
    else:
        post = _posterior_model(fp, x, noise, y, noise_pred, engine=engine)
        m, v = lgssm_mod.marginals_diag(post, engine=engine)
    return m.reshape(-1)[idx], v.reshape(-1)[idx]


def mean_and_var(fxp, *, engine=None):
    return marginals(fxp, engine=engine)


def mean(fxp, *, engine=None):
    return marginals(fxp, engine=engine)[0]


def var(fxp, *, engine=None):
    return marginals(fxp, engine=engine)[1]


def rand(generator, fxp: FinitePosteriorLTISDE, *, engine=None):
    """A joint posterior sample at fxp.x, the prediction noise included;
    the normals from `generator`, a torch.Generator on the model's
    device."""
    post, idx = _merged_posterior(fxp, engine)
    return lgssm_mod.rand(generator, post, engine=engine).reshape(-1)[idx]


def logpdf(fxp: FinitePosteriorLTISDE, y_pr, *, engine=None):
    """The posterior predictive log density of y_pr at fxp.x (NaN =
    missing): the reverse-ordered posterior LGSSM's lml of y_pr at the
    prediction indices, the training ones missing."""
    post, idx = _merged_posterior(fxp, engine)
    y_full = torch.full((len(post) * em.dim_out(post.emis),), float("nan"), dtype=post.dtype,
                        device=post.device)
    y_full[idx] = torch.as_tensor(y_pr, dtype=post.dtype, device=post.device)
    if not isinstance(post.emis, ScalarEmissions):
        y_full = y_full.reshape(len(post), -1)  # a grid's time form
    return missings_mod.logpdf_with_missings(post, y_full, engine=engine)


def cov(fxp: FinitePosteriorLTISDE):
    """Refused, as in the reference: the dense posterior covariance is
    O(N^2) memory and defeats the state-space representation."""
    raise NotImplementedError(
        "Intentionally not implemented. Please don't try to explicitly "
        "compute this covariance matrix."
    )
