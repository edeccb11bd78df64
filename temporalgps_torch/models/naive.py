"""The dense-Gaussian oracle of an LGSSM (temporalgps_tpu/models/naive.py):
the Markov chain composed into one joint Gaussian over all observations, in
numpy float64, for `logpdf`, marginals and the posterior of any emission
type, of a model on either device. O((N Dout)^3): test sizes only, never on
a hot path."""

import numpy as np
import torch

from ..utils.fill import Fill, is_fill
from . import emissions as em
from .gauss_markov import GaussMarkov
from .lgssm import LGSSM


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _at(leaf, t):
    """Step t of a per-step leaf, as float64 numpy."""
    return _np(leaf.value if is_fill(leaf) else leaf[t])


def _effective_emission(e, t):
    """(A, a, Sigma) of step t: y = A x + a + N(0, Sigma), Sigma dense."""
    if isinstance(e, em.ScalarEmissions):
        return _at(e.H, t)[None, :], np.atleast_1d(_at(e.h, t)), np.atleast_2d(_at(e.s, t))
    if isinstance(e, em.DenseEmissions):
        return _at(e.H, t), _at(e.h, t), _at(e.S, t)
    if isinstance(e, em.LargeEmissions):
        return _at(e.C, t), _at(e.c, t), np.diag(_at(e.s_diag, t))
    if isinstance(e, em.BottleneckEmissions):
        C = _at(e.C, t)
        return C @ _at(e.H, t), C @ _at(e.h, t) + _at(e.c, t), np.diag(_at(e.s_diag, t))
    raise TypeError(type(e))


def _latent_joint(trans: GaussMarkov, order):
    """Means and covariances of the chain's states s_0 .. s_N in iteration
    order: s_0 ~ x0, s_{k+1} = trans[order[k]](s_k)."""
    Ms = [_np(trans.x0.mean)]
    covs = {(0, 0): _np(trans.x0.cov)}
    for k, t in enumerate(order):
        A, a, Q = _at(trans.As, t), _at(trans.offs, t), _at(trans.Qs, t)
        i = k + 1
        Ms.append(A @ Ms[k] + a)
        covs[(i, i)] = A @ covs[(k, k)] @ A.T + Q
        for j in range(i):
            covs[(i, j)] = A @ covs[(k, j)] if j < k else A @ covs[(k, k)]
    return Ms, covs


def joint_observation_gaussian(model: LGSSM):
    """(mean, covariance) of the flat vector of all observations, ordered by
    time (not iteration order), and each step's observation count. A forward
    model emits from the state after its transition, a reverse one from the
    state before it."""
    N = len(model)
    forward = model.trans.forward
    order = list(range(N)) if forward else list(range(N - 1, -1, -1))
    Ms, covs = _latent_joint(model.trans, order)
    As_e, as_e, Ss_e = zip(*(_effective_emission(model.emis, t) for t in order))
    dims = [A.shape[0] for A in As_e]
    state = (lambda k: k + 1) if forward else (lambda k: k)

    offsets = np.concatenate([[0], np.cumsum(dims)])
    mean = np.zeros(offsets[-1])
    cov = np.zeros((offsets[-1], offsets[-1]))
    for k in range(N):
        sk = slice(offsets[k], offsets[k + 1])
        mean[sk] = As_e[k] @ Ms[state(k)] + as_e[k]
        cov[sk, sk] = As_e[k] @ covs[(state(k), state(k))] @ As_e[k].T + Ss_e[k]
        for j in range(k):
            sj = slice(offsets[j], offsets[j + 1])
            block = As_e[k] @ covs[(state(k), state(j))] @ As_e[j].T
            cov[sk, sj] = block
            cov[sj, sk] = block.T
    if not forward:  # iteration order -> time order: step t is iteration N - 1 - t
        perm = np.concatenate([np.arange(offsets[N - 1 - t], offsets[N - t]) for t in range(N)])
        mean, cov = mean[perm], cov[np.ix_(perm, perm)]
    return mean, cov, np.asarray(dims if forward else dims[::-1])


def _gaussian_logpdf(mean, cov, y):
    L = np.linalg.cholesky(cov)
    alpha = np.linalg.solve(L, y - mean)
    return float(-0.5 * (len(y) * np.log(2 * np.pi) + 2 * np.sum(np.log(np.diag(L)))
                         + alpha @ alpha))


def naive_logpdf(model: LGSSM, y):
    mean, cov, _ = joint_observation_gaussian(model)
    return _gaussian_logpdf(mean, cov, _np(y).reshape(-1))


def naive_marginals(model: LGSSM):
    """Per-step observation-space marginals (list of means, list of
    covariances)."""
    mean, cov, dims = joint_observation_gaussian(model)
    offsets = np.concatenate([[0], np.cumsum(dims)])
    sl = [slice(offsets[t], offsets[t + 1]) for t in range(len(dims))]
    return [mean[s] for s in sl], [cov[s, s] for s in sl]


def _latent_and_cross(model: LGSSM):
    """(obs mean, obs cov, latent mean, latent cov, cross cov latent x obs,
    per-step emission matrices) of a forward model, the latent joint from
    the same chain observed through identity emissions without noise."""
    assert model.trans.forward, "the oracle posterior is implemented for forward priors"
    N, D = len(model), model.latent_dim
    mean, cov, dims = joint_observation_gaussian(model)
    ident = LGSSM(model.trans, em.DenseEmissions(H=Fill(np.eye(D), N), h=Fill(np.zeros(D), N),
                                                 S=Fill(np.zeros((D, D)), N)))
    lat_mean, lat_cov, _ = joint_observation_gaussian(ident)
    As_e = [_effective_emission(model.emis, t)[0] for t in range(N)]
    offsets = np.concatenate([[0], np.cumsum(dims)])
    cross = np.zeros((N * D, offsets[-1]))
    for tj in range(N):
        sj = slice(offsets[tj], offsets[tj + 1])
        cross[:, sj] = lat_cov[:, tj * D:(tj + 1) * D] @ As_e[tj].T
    return mean, cov, lat_mean, lat_cov, cross, As_e


def naive_posterior_logpdf(model: LGSSM, y, y2):
    """The oracle of logpdf(posterior(model, y), y2): log p(y2' | y), y2' a
    fresh noisy observation of the same latent chain (the posterior LGSSM
    keeps the prior's emissions), with independent noise on each copy."""
    N, D = len(model), model.latent_dim
    mean, cov, lat_mean, lat_cov, cross, As_e = _latent_and_cross(model)
    # The noise-free observation covariance, emission by emission.
    dims = [A.shape[0] for A in As_e]
    offsets = np.concatenate([[0], np.cumsum(dims)])
    C = np.zeros_like(cov)
    for ti in range(N):
        si = slice(offsets[ti], offsets[ti + 1])
        C[si, :] = As_e[ti] @ cross[ti * D:(ti + 1) * D, :]
    sol = np.linalg.solve(cov, _np(y).reshape(-1) - mean)
    cond_mean = mean + C @ sol
    cond_cov = cov - C @ np.linalg.solve(cov, C.T)
    return _gaussian_logpdf(cond_mean, cond_cov, _np(y2).reshape(-1))


def naive_posterior_marginals(model: LGSSM, y):
    """Per-step observation-space posterior marginals of the noisy
    observations given y (lists of means and covariances): the latent joint
    conditioned on y, then each step's emission."""
    N, D = len(model), model.latent_dim
    mean, cov, lat_mean, lat_cov, cross, As_e = _latent_and_cross(model)
    d = _np(y).reshape(-1) - mean
    lat_post_mean = lat_mean + cross @ np.linalg.solve(cov, d)
    lat_post_cov = lat_cov - cross @ np.linalg.solve(cov, cross.T)
    means, covs = [], []
    for t in range(N):
        A_e, a_e, S_e = _effective_emission(model.emis, t)
        st = slice(t * D, (t + 1) * D)
        means.append(A_e @ lat_post_mean[st] + a_e)
        covs.append(A_e @ lat_post_cov[st, st] @ A_e.T + S_e)
    return means, covs
