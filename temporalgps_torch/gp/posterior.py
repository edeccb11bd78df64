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
from ..models import lgssm as lgssm_mod
from ..models import missings as missings_mod
from ..utils.fill import is_fill
from ..utils.regular_spacing import RegularSpacing, num_times, time_array
from .lti_sde import LTISDE, FiniteLTISDE, _canon_noise, _storage_dtype, build_lgssm

_GRID_ITEM = "grid inputs (RectilinearGrid) wait for the space-time port (ROADMAP Queue 1 item 7)"


@dataclasses.dataclass(frozen=True, eq=False)
class PosteriorLTISDE:
    prior: LTISDE
    y: torch.Tensor
    x: Any
    noise: Any

    def __call__(self, x_pr, noise=None):
        _check_time_series(x_pr)
        dtype = _storage_dtype(self.prior.storage)
        return FinitePosteriorLTISDE(self, x_pr, _canon_noise(noise, x_pr, dtype,
                                                               self.prior.device))


@dataclasses.dataclass(frozen=True, eq=False)
class FinitePosteriorLTISDE:
    f: PosteriorLTISDE
    x: Any
    noise: Any


def _check_time_series(x):
    """The inputs ported: RegularSpacing or a vector of times."""
    if isinstance(x, RegularSpacing) or (x.ndim if hasattr(x, "ndim") else np.ndim(x)) == 1:
        return
    raise NotImplementedError(f"{type(x).__name__} inputs: {_GRID_ITEM}")


def posterior(fx: FiniteLTISDE, y) -> PosteriorLTISDE:
    """The lazy posterior of fx given y (NaN = missing)."""
    _check_time_series(fx.x)
    dtype = _storage_dtype(fx.f.storage)
    return PosteriorLTISDE(fx.f, torch.as_tensor(y, dtype=dtype, device=fx.f.device),
                           fx.x, fx.noise)


def _noise_array(noise, N):
    return noise.value.expand(N) if is_fill(noise) else noise


def _times_of(x):
    return time_array(x).detach().cpu().numpy()


def _same_inputs(x1, x2) -> bool:
    if x1 is x2:
        return True
    t1, t2 = _times_of(x1), _times_of(x2)
    return t1.shape == t2.shape and bool(np.all(t1 == t2))


def _build_inference_data(fp: PosteriorLTISDE, x_pr):
    """Merged, time-sorted (times, noise, y with NaN at the prediction
    points, tr_idx, pr_idx); the sort and ranks are host-side numpy."""
    t_tr, t_pr = _times_of(fp.x), _times_of(x_pr)
    n_tr, n_pr = len(t_tr), len(t_pr)
    t_all = np.concatenate([t_tr, t_pr])
    order = np.argsort(t_all, kind="stable")
    rank = np.argsort(order, kind="stable")
    tr_idx, pr_idx = rank[:n_tr], rank[n_tr:]

    device = fp.y.device
    order_t = torch.as_tensor(order, device=device)
    noise_tr = _noise_array(fp.noise, n_tr)
    noise_all = torch.cat([noise_tr, noise_tr.new_full((n_pr,), LARGE_VAR)])[order_t]
    y_all = torch.cat([fp.y, fp.y.new_full((n_pr,), float("nan"))])[order_t]
    x_sorted = torch.as_tensor(t_all[order], device=device)
    return x_sorted, noise_all, y_all, tr_idx, pr_idx


def _pred_noise_full(pr_idx, n, noise_pr, dtype, device):
    """Zeros at the training indices, the prediction noise at the prediction
    indices."""
    out = torch.zeros(n, dtype=dtype, device=device)
    out[torch.as_tensor(pr_idx, device=device)] = _noise_array(noise_pr, len(pr_idx)).to(dtype)
    return out


def _posterior_model(fp, x_sorted, noise_all, y_all, noise_pred_full, *, engine=None):
    model = build_lgssm(fp.prior(x_sorted, noise_all))
    post = missings_mod.posterior_with_missings(model, y_all, engine=engine)
    return missings_mod.replace_observation_noise_cov(post, noise_pred_full)


def _merged_posterior(fxp: FinitePosteriorLTISDE, engine):
    """(posterior LGSSM over the merged times, with the prediction noise at
    the prediction indices and zero at the training ones; the prediction
    indices as a tensor on its device)."""
    fp = fxp.f
    x_sorted, noise_all, y_all, _tr_idx, pr_idx = _build_inference_data(fp, fxp.x)
    noise_pred = _pred_noise_full(pr_idx, len(x_sorted), fxp.noise,
                                  _storage_dtype(fp.prior.storage), y_all.device)
    post = _posterior_model(fp, x_sorted, noise_all, y_all, noise_pred, engine=engine)
    return post, torch.as_tensor(pr_idx, device=y_all.device)


def marginals(fxp: FinitePosteriorLTISDE, *, engine=None):
    """Posterior marginal (means, variances) at fxp.x, including the
    prediction noise fxp.noise."""
    fp = fxp.f
    if _same_inputs(fxp.x, fp.x):
        noise_pred = _noise_array(fxp.noise, num_times(fxp.x))
        post = _posterior_model(fp, fp.x, fp.noise, fp.y, noise_pred, engine=engine)
        return lgssm_mod.marginals_diag(post, engine=engine)
    post, idx = _merged_posterior(fxp, engine)
    m, v = lgssm_mod.marginals_diag(post, engine=engine)
    return m[idx], v[idx]


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
    return lgssm_mod.rand(generator, post, engine=engine)[idx]


def logpdf(fxp: FinitePosteriorLTISDE, y_pr, *, engine=None):
    """The posterior predictive log density of y_pr at fxp.x (NaN =
    missing): the reverse-ordered posterior LGSSM's lml of y_pr at the
    prediction indices, the training ones missing."""
    post, idx = _merged_posterior(fxp, engine)
    y_full = torch.full((len(post),), float("nan"), dtype=post.dtype, device=post.device)
    y_full[idx] = torch.as_tensor(y_pr, dtype=post.dtype, device=post.device)
    return missings_mod.logpdf_with_missings(post, y_full, engine=engine)


def cov(fxp: FinitePosteriorLTISDE):
    """Refused, as in the reference: the dense posterior covariance is
    O(N^2) memory and defeats the state-space representation."""
    raise NotImplementedError(
        "Intentionally not implemented. Please don't try to explicitly "
        "compute this covariance matrix."
    )
