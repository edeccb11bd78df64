"""Closed-form logpdf gradients by the Fisher identity, innovations form
(temporalgps_tpu/ops/fisher.py).

The gradient of the lml is the expected complete-data score under the
smoothing posterior,

    d lml / d theta = E_q[ d log p(x, y; theta) / d theta ],

which needs only the filter's predictions and the smoother's marginals: a
few forward-speed passes whose cost does not depend on the number of
hyperparameters, and no reverse-mode residuals of the filter.

The textbook statistics contract with Q^{-1}, whose smallest eigenvalue
scales like (lam dt)^(2p+1) for a Matern-p/2 model. With J the RTS gain (the
reverse-LGSSM transition), G = Q P_pred^{-1}, and A J = I - G, G P_pred = Q:

    E[w_t]          = G (mu_t - m_pred_t)
    Cov[w_t] - Q    = G (Sig_t - P_pred_t) G'
    Cov[w_t, x_t-1] = G (Sig_t - P_pred_t) J'

so Q^{-1} G = P_pred^{-1} leaves only contractions with the predicted
covariance:

    dA_t = P_pred^{-1} [ (Sig_t - P_pred) J' + (mu_t - m_pred) mu^s_t-1' ]
    da_t = P_pred^{-1} (mu_t - m_pred)
    dQ_t = 1/2 P_pred^{-1} [ (Sig_t - P_pred)
                             + (mu_t - m_pred)(mu_t - m_pred)' ] P_pred^{-1}

and x0 takes the same form with the prior in place of the prediction. This
is Koopman's exact score in disturbance-smoother variables, so a
semi-definite Q is fine. Forward-ordered, scalar-emission models.

`logpdf_fisher` is a torch.autograd.Function: its forward is the block
engine's logpdf (K1-K3 on the card), its backward `fisher_cotangents` on the
chosen engine. On the card engine="block" runs the kernels there too: the
filter on K1, K2, K7, then the reversal of the dynamics against its
predictions (elementwise tensor ops, float64), and the posterior's latent
marginals on K8, K9, K10; engine="parallel" runs ops/assoc.py's scans in
tensor ops.
"""

import functools

import torch

from ..models import lgssm as lg
from ..models.emissions import ScalarEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM, model_leaves, model_like
from ..utils import psd
from ..utils.fill import Fill, is_fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from . import block
from .assoc import _mT, _mv, _reversed_model_matrix


def _exact_posterior(model, filt, jitter=0.0):
    """(posterior, predictions) from the stacked filtering states: the
    dynamics of every step inverted against its prediction in float64, as
    every engine's posterior inverts them (for D <= 3 elementwise on (N,)
    components, `block._reversed_model`; else batched,
    `assoc._reversed_model_matrix`), with no jitter on the predicted
    covariances."""
    if model.latent_dim <= 3:
        return block._reversed_model(model, block._gaussian_to_comps(filt), jitter)
    return _reversed_model_matrix(model, filt, jitter)


def _posterior_stats(model, y, engine):
    """(mu, Sig, mu_prev, Sig_prev0, J, m_pred, P_pred), batched over time:
    the smoothed marginals, the smoothed state before each step, the
    initial state's smoothed covariance, the RTS gains (the reverse model's
    transitions), and the filter's predictions.

    One filter pass gives both the predictions and the posterior
    (`_exact_posterior`). It is the exact smoother, with no jitter on the predicted
    covariances it inverts (the reference adds POSTERIOR_JITTER, 1e-10): at
    small lam dt the jitter moves the smoothed moments, and the gradient
    with them, by about jitter / the smallest eigenvalue of P_pred
    (probes/torch_fisher_jitter.py). The contractions below factor P_pred
    without jitter too, as the reference's do."""
    post, pred = _exact_posterior(model, lg.filter_(model, y, engine=engine))
    xs = lg.latent_marginals(post, engine=engine)  # mu_t, Sig_t for t = 1..N
    mu, Sig = xs.mean, symmetrize(xs.cov)
    J, a_rev, Q_rev = (tmaterialize(leaf) for leaf in (post.trans.As, post.trans.offs,
                                                        post.trans.Qs))
    mu_prev = _mv(J, mu) + a_rev  # smoothed x_{t-1}
    Sig_prev0 = symmetrize(J[0] @ Sig[0] @ J[0].T + Q_rev[0])
    return (mu, Sig, mu_prev, Sig_prev0, J, pred.mean.to(model.dtype),
            pred.cov.to(model.dtype))


def fisher_cotangents(model, y, g, *, engine="parallel"):
    """Cotangents (model_bar, y_bar) of g * logpdf(model, y): an LGSSM of
    the model's structure whose leaves are the cotangents (a Fill leaf's
    summed over time, a per-step leaf's per step), and y's."""
    e = model.emis
    if not (isinstance(e, ScalarEmissions) and model.trans.forward):
        raise ValueError("the Fisher gradient takes forward-ordered scalar-emission models")
    mu, Sig, mu_prev, Sig_prev0, J, m_pred, P_pred = _posterior_stats(model, y, engine)
    H, h, s = (tmaterialize(leaf) for leaf in (e.H, e.h, e.s))

    # Transitions, in innovations form.
    Lp = psd.cholesky(P_pred)
    d = mu - m_pred
    X = Sig - P_pred
    da = psd.chol_solve(Lp, d[..., :, None])[..., 0]
    dA = psd.chol_solve(Lp, X @ _mT(J) + d[..., :, None] * mu_prev[..., None, :])
    S_q = X + d[..., :, None] * d[..., None, :]
    dQ = 0.5 * _mT(psd.chol_solve(Lp, _mT(psd.chol_solve(Lp, S_q))))

    # Emissions.
    r = y - ((H * mu).sum(-1) + h)
    HSig = torch.einsum("ni,nij->nj", H, Sig)
    dH = (r[:, None] * mu - HSig) / s[:, None]
    dh = r / s
    ds = 0.5 * (r * r + (HSig * H).sum(-1) - s) / (s * s)
    dy = -r / s

    # The initial state: the same form with the prior as the prediction.
    m0, P0 = model.trans.x0.mean, symmetrize(model.trans.x0.cov)
    L0 = psd.cholesky(P0)
    d0 = mu_prev[0] - m0
    dm0 = psd.chol_solve(L0, d0[:, None])[:, 0]
    dP0 = 0.5 * psd.chol_solve(L0, psd.chol_solve(L0, (Sig_prev0 - P0) + torch.outer(d0, d0)).T)

    def like(leaf, grads):
        return Fill(g * grads.sum(0), leaf.N) if is_fill(leaf) else g * grads

    t = model.trans
    trans_bar = GaussMarkov(As=like(t.As, dA), offs=like(t.offs, da), Qs=like(t.Qs, dQ),
                            x0=Gaussian(g * dm0, g * dP0), forward=True, det_blocks=t.det_blocks)
    emis_bar = ScalarEmissions(H=like(e.H, dH), h=like(e.h, dh), s=like(e.s, ds))
    return LGSSM(trans_bar, emis_bar), g * dy


class _LogpdfFisher(torch.autograd.Function):
    """logpdf over the model's leaf tensors (`models.lgssm.model_leaves`) and
    y: forward the block engine, backward `fisher_cotangents`."""

    @staticmethod
    def forward(ctx, like, n_blocks, engine, y, *leaves):
        ctx.like, ctx.engine = like, engine
        ctx.save_for_backward(y, *leaves)
        return block.logpdf(like(leaves), y, n_blocks=n_blocks)

    @staticmethod
    def backward(ctx, g):
        y, *leaves = ctx.saved_tensors
        model_bar, y_bar = fisher_cotangents(ctx.like(leaves), y, g, engine=ctx.engine)
        return (None, None, None, y_bar, *model_leaves(model_bar))


def logpdf_fisher(model, y, n_blocks=None, engine="parallel"):
    """logpdf with the closed-form Fisher-identity gradient: forward on the
    block engine, backward the posterior statistics on `engine` and their
    contractions. y holds no NaN (fill missing observations first,
    `models.missings.transform_model_and_obs`)."""
    y = torch.as_tensor(y, dtype=model.dtype, device=model.device)
    return _LogpdfFisher.apply(functools.partial(model_like, model), n_blocks, engine, y,
                               *model_leaves(model))
