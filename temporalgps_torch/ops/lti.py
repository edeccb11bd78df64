"""The time-invariant engine, engine="lti" (temporalgps_tpu/ops/lti.py).

For a forward model whose transition and emission leaves are all Fills (a
RegularSpacing model, a regular grid's space-time or pseudo-point model)
the Kalman covariance recursion does not depend on the data: every step's
filtering element shares its (A, C, J) components. So:

  1. covariance pass: the filtering covariance at every step is the prior
     composed with the t-th power of the constant element, the powers
     E^1..E^L within a block by doubling (`_all_powers`), the block starts
     E^(bL) by one associative scan over B, and all N states by one
     (B, L)-batched combine. No Cholesky inside a recursion.
  2. data pass: the filtering means solve m_t = G_t m_{t-1} + w_t, with
     G_t from the covariances and w_t one batched product with the data,
     by an associative scan of affine maps.
  3. lml: batched over all N steps from the predictions, every factor D x D
     (the input-space identities of `assoc.element_dense_diag`).

Missing data is not taken: its large-variance fill makes the noise leaf
per step. Callers route such models to the other engines
(models/missings.py raises for a NaN). The reference's component-major
layout (ops/lti_cm.py) and its chunking of the covariance pass exist for the
TPU's tiles and memory; the card needs neither at the sizes measured
(PERF.md), so the port has neither.
"""

import math

import torch

from ..config import POSTERIOR_JITTER
from ..models import emissions as em
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..utils import psd
from ..utils.fill import is_fill
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from .assoc import _associative_scan, _combine_affine, _combine_affine_mean, _combine_filter


def _mT(X):
    return X.transpose(-1, -2)


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def supported(model) -> bool:
    """A forward model whose every transition and emission leaf is a Fill."""
    t = model.trans
    return t.forward and all(is_fill(leaf) for leaf in (t.As, t.offs, t.Qs, *em.leaves(model.emis)))


def _single(e):
    """The emission container with each Fill leaf by its value."""
    return em.map_leaves(lambda leaf: leaf.value if is_fill(leaf) else leaf, e)


def _cast(tree, dtype):
    return tuple(x.to(dtype) for x in tree)


def _ident_elem(D, dtype, device):
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return (torch.eye(D, dtype=dtype, device=device), z(D), z(D, D), z(D), z(D, D))


def _all_powers(E1, L, combine):
    """E^1..E^L, stacked on a leading axis, by doubling: each level one
    batched combine of the latest power with the powers so far, log2(L)
    levels."""
    E_pows = tuple(x[None] for x in E1)
    m = 1
    while m < L:
        take = min(m, L - m)
        E_m = tuple(x[m - 1].expand(take, *x.shape[1:]) for x in E_pows)
        nxt = combine(E_m, tuple(x[:take] for x in E_pows))  # E^(m+1)..E^(m+take)
        E_pows = tuple(torch.cat([a, b]) for a, b in zip(E_pows, nxt))
        m += take
    return E_pows


def _const_element(model, dtype):
    """(the shared filtering element of a step at y = 0, (A, a, Q), the
    emission container's values), in `dtype`: only the element's data-free
    (A, C, J) components are used. The same element constructor as the
    other engines (`assoc.step_elements`)."""
    from .assoc import step_elements

    t = model.trans
    e = em.map_leaves(lambda v: v.to(dtype), _single(model.emis))
    A0, a0, Q0 = (leaf.value.to(dtype) for leaf in (t.As, t.offs, t.Qs))
    y0 = torch.zeros(() if isinstance(e, em.ScalarEmissions) else (em.dim_out(e),),
                     dtype=dtype, device=A0.device)
    return step_elements(A0, a0, Q0, e, y0), (A0, a0, Q0), e


def _block_starts(E_L, B, combine, ident):
    """E^(bL) for b = 0..B-1 (the identity first), by one associative scan."""
    if B == 1:
        return tuple(x[None] for x in ident)
    S = _associative_scan(combine, tuple(x.expand(B - 1, *x.shape) for x in E_L))
    return tuple(torch.cat([i[None], s]) for i, s in zip(ident, S))


def _cov_chain(model, N, B, dtype, hi_mode=None):
    """The constant element's power chain: (St, E_pows, e0, (A, a, Q), the
    emission values), St the (B,) block starts composed with the prior,
    E_pows the (L,) powers E^1..E^L. hi_mode None runs all of it in `dtype`;
    "chain" runs the chain in float64 and casts St and E_pows to `dtype`;
    "full" leaves them in float64 for a float64 outer combine."""
    D = model.latent_dim
    L = N // B
    hi = torch.float64 if hi_mode else dtype
    device = model.device
    e0, trans0, e_single = _const_element(model, hi)
    z = torch.zeros(D, dtype=hi, device=device)
    E_pows = _all_powers((e0[0], z, e0[2], z, e0[4]), L, _combine_filter)
    S = _block_starts(tuple(x[-1] for x in E_pows), B, _combine_filter,
                      _ident_elem(D, hi, device))
    x0 = model.trans.x0
    prior = (torch.zeros(1, D, D, dtype=hi, device=device), x0.mean[None].to(hi),
             symmetrize(x0.cov)[None].to(hi), z[None], torch.zeros(1, D, D, dtype=hi, device=device))
    St = _combine_filter(prior, S)
    if hi != dtype:
        if hi_mode == "chain":
            St, E_pows = _cast(St, dtype), _cast(E_pows, dtype)
        e0, trans0 = _cast(e0, dtype), _cast(trans0, dtype)
        e_single = em.map_leaves(lambda v: v.to(dtype), e_single)
    return St, E_pows, e0, trans0, e_single


def _cov_pass(model, N, B, dtype, hi_mode=None):
    """(P_f, e0, (A, a, Q), emission values): P_f (N, D, D) the filtering
    covariance after each step, from the power chain by one (B, L)-batched
    combine of the block starts with the powers. N = B L exactly. hi_mode
    as `_cov_chain`'s: "full" runs the outer combine in float64 too (the
    steady engine's short warmup, whose gradients it feeds)."""
    St, E_pows, e0, trans0, e_single = _cov_chain(model, N, B, dtype, hi_mode)
    D = model.latent_dim
    P_f = _combine_filter(tuple(x[:, None] for x in St), tuple(x[None] for x in E_pows))[2]
    return P_f.reshape(N, D, D).to(dtype), e0, trans0, e_single


def _gain_ops_vector(P_pred, H, R_isqrt_fn, dtype):
    """The batched input-space operators of vector emissions with a constant
    H (Dout, D): Gram = H' R^{-1} H, Lpp = chol(P_pred + POSTERIOR_JITTER I),
    T = Lpp' Gram, Lf = chol(I + T Lpp) and its log-determinant."""
    Hw = R_isqrt_fn(H)
    Gram = symmetrize(_mT(Hw) @ Hw)
    Lpp = psd.cholesky(psd.add_jitter(symmetrize(P_pred), POSTERIOR_JITTER))
    T = _mT(Lpp) @ Gram
    eye = torch.eye(P_pred.shape[-1], dtype=dtype, device=P_pred.device)
    Lf = psd.cholesky(symmetrize(T @ Lpp) + eye)
    logdetFm = 2.0 * torch.log(torch.diagonal(Lf, dim1=-2, dim2=-1)).sum(-1)
    return dict(Hw=Hw, Gram=Gram, Lpp=Lpp, T=T, Lf=Lf, logdetFm=logdetFm)


def _HtSinv_apply(ops, u):
    """H' S^{-1} r from u = H' R^{-1} r: u - T' Fm^{-1} (Lpp' u), batched."""
    Lpu = torch.einsum("...ji,...j->...i", ops["Lpp"], u)
    Fi = psd.chol_solve(ops["Lf"], Lpu[..., None])[..., 0]
    return u - torch.einsum("...ji,...j->...i", ops["T"], Fi)


def _fit_blocks(N, n_blocks):
    """A block count dividing N: the large-variance padding of the other
    engines would make the noise leaf per step."""
    from .block import _default_blocks

    B = min(n_blocks or _default_blocks(N), N)
    while N % B:
        B //= 2
    return B


def _filter_pass(model, y, n_blocks=None, cov_hi=False):
    """Every filtering quantity of a Fill model: the means and covariances
    after each step, the predictions, the emission-side operators; shared by
    logpdf, posterior and the steady engine's warmup. cov_hi is
    `_cov_pass`'s hi_mode (None or False, "chain", or "full"; True means
    "full"): reverse mode through a float32 power chain loses accuracy
    linearly in its depth."""
    D = model.latent_dim
    x0 = model.trans.x0
    dtype = x0.mean.dtype
    N = len(model)
    B = _fit_blocks(N, n_blocks)
    y = y.to(dtype)
    P_f, e0, (A0, a0, Q0), e_single = _cov_pass(
        model, N, B, dtype, hi_mode="full" if cov_hi is True else (cov_hi or None))
    P_prev = torch.cat([symmetrize(x0.cov)[None].to(dtype), P_f[:-1]])
    P_pred = symmetrize(A0 @ P_prev @ A0.T + Q0)

    scalar = isinstance(model.emis, em.ScalarEmissions)
    if scalar:
        H, h, s = e_single.H, e_single.h, e_single.s
        Sv = torch.einsum("i,nij,j->n", H, P_pred, H) + s
        K = torch.einsum("nij,j->ni", P_pred, H) / Sv[:, None]
        G = A0 - K[:, :, None] * (H @ A0)[None, None, :]            # (I - K H) A
        w = (a0[None] - K * (H @ a0)) + K * (y - h)[:, None]        # (I - K H) a + K (y - h)
    else:
        H_eff, h_eff, R_kind, R_payload = _effective_emission(e_single)
        R_isqrt_fn, R_inv_fn, logdetR, quad_R = R_kind_ops(R_kind, R_payload)
        ops = _gain_ops_vector(P_pred, H_eff, R_isqrt_fn, dtype)
        M1 = symmetrize(ops["Gram"] - _mT(ops["T"]) @ psd.chol_solve(ops["Lf"], ops["T"]))
        G = A0[None] - P_pred @ (M1 @ A0[None])                     # A - P_pred H'S^{-1}H A
        u = torch.einsum("ji,...j->...i", R_inv_fn(H_eff), y - h_eff[None])
        w = (a0[None] - torch.einsum("nij,nj->ni", P_pred, _mv(M1, a0))
             + torch.einsum("nij,nj->ni", P_pred, _HtSinv_apply(ops, u)))

    means = affine_means(G, w, x0.mean.to(dtype))
    m_prev = torch.cat([x0.mean[None].to(dtype), means[:-1]])
    m_pred = m_prev @ A0.T + a0
    out = dict(y=y, dtype=dtype, scalar=scalar, trans0=(A0, a0, Q0), e_single=e_single,
               means=means, m_prev=m_prev, m_pred=m_pred, P_f=P_f, P_prev=P_prev, P_pred=P_pred)
    if scalar:
        out.update(H=H, h=h, s=s, Sv=Sv)
    else:
        out.update(H_eff=H_eff, h_eff=h_eff, ops=ops, R_inv_fn=R_inv_fn, logdetR=logdetR,
                   quad_R=quad_R)
    return out


def affine_means(G, w, m0):
    """m_t = G_t m_{t-1} + w_t, t = 1..N, from m0: the associative scan of
    the affine maps (G_t, w_t) with m0 in front; (N, D)."""
    prior = (torch.zeros_like(G[:1]), m0[None])
    return _associative_scan(_combine_affine_mean,
                             (torch.cat([prior[0], G]), torch.cat([prior[1], w])))[1][1:]


def logpdf(model, y, *, n_blocks=None):
    """lml of a Fill-parameter forward model; no missing data."""
    return _lml_from_filter(_filter_pass(model, y, n_blocks))


def _lml_from_filter(q):
    """The sum of the per-step lml terms of a `_filter_pass` result (also the
    steady engine's exact warmup)."""
    y, m_pred = q["y"], q["m_pred"]
    if q["scalar"]:
        r = y - (m_pred @ q["H"] + q["h"])
        return -0.5 * (torch.log(q["Sv"]) + r * r / q["Sv"] + math.log(2.0 * math.pi)).sum()
    H_eff, ops = q["H_eff"], q["ops"]
    r = y - (m_pred @ H_eff.T + q["h_eff"])
    v = torch.einsum("nji,nj->ni", ops["Lpp"], r @ q["R_inv_fn"](H_eff))  # Lpp' H'R^{-1} r
    Fi = psd.chol_solve(ops["Lf"], v[..., None])[..., 0]
    quad = q["quad_R"](r) - (v * Fi).sum(-1)
    return -0.5 * (ops["logdetFm"] + q["logdetR"] + quad
                   + y.shape[-1] * math.log(2.0 * math.pi)).sum()


def posterior(model, y, *, n_blocks=None, cov_hi=False):
    """The smoother as a reverse-ordered LGSSM (models.lgssm.posterior): the
    filter's quantities, then every step's dynamics inverted at once,
    POSTERIOR_JITTER on each prediction. Its transitions are per step, so
    other engines run it. `cov_hi` as `_filter_pass`'s."""
    q = _filter_pass(model, y, n_blocks, cov_hi=cov_hi)
    A0 = q["trans0"][0]
    m_prev, P_prev = q["m_prev"], q["P_prev"]
    Lp = psd.cholesky(psd.add_jitter(q["P_pred"], POSTERIOR_JITTER))
    G = _mT(psd.chol_solve(Lp, A0 @ P_prev))
    trans = GaussMarkov(As=G, offs=m_prev - _mv(G, q["m_pred"]),
                        Qs=symmetrize(P_prev - G @ (A0 @ P_prev)),
                        x0=Gaussian(q["means"][-1], symmetrize(q["P_f"][-1])), forward=False)
    return LGSSM(trans, model.emis)


def _effective_emission(e):
    """(H, h, R kind, R payload) of one step's vector emissions, y = H x + h
    + noise: the kind "diag" (payload s_diag) for Large and Bottleneck ones,
    "dense" (payload S) for Dense ones."""
    diag = em.diag_noise_params(e)
    if diag is not None:
        return diag[0], diag[1], "diag", diag[2]
    if isinstance(e, em.DenseEmissions):
        return e.H, e.h, "dense", e.S
    raise TypeError(type(e))


def R_kind_ops(kind, payload):
    """(R^{-1/2} X, R^{-1} X, log det R, r' R^{-1} r) of a constant noise,
    the functions taking (Dout, k) or (..., Dout) operands."""
    if kind == "diag":
        s = payload
        isq = 1.0 / torch.sqrt(s)
        return (lambda X: X * isq[:, None] if X.ndim == 2 else X * isq,
                lambda X: X / s[:, None] if X.ndim == 2 else X / s,
                torch.log(s).sum(),
                lambda r: (r * r / s).sum(-1))
    Ls = psd.cholesky(symmetrize(payload))
    logdetR = 2.0 * torch.log(torch.diagonal(Ls)).sum()
    col = lambda f, X: f(X[..., None])[..., 0] if X.ndim == 1 else f(X)

    def quad(r):
        z = psd.tri_solve(Ls, r[..., None])[..., 0]
        return (z * z).sum(-1)

    return (lambda X: col(lambda B: psd.tri_solve(Ls, B), X),
            lambda X: col(lambda B: psd.chol_solve(Ls, B), X), logdetR, quad)


def latent_marginals(model, *, n_blocks=None) -> Gaussian:
    """Prior latent marginals of a Fill model: the affine maps' powers
    within a block, the block starts by one scan, all N by one batched
    combine; no O(N) recursion."""
    D = model.latent_dim
    x0 = model.trans.x0
    dtype, device = x0.mean.dtype, model.device
    N = len(model)
    B = _fit_blocks(N, n_blocks)
    t = model.trans
    A0, a0, Q0 = (leaf.value.to(dtype) for leaf in (t.As, t.offs, t.Qs))
    E_pows = _all_powers((A0, a0, symmetrize(Q0)), N // B, _combine_affine)
    ident = (torch.eye(D, dtype=dtype, device=device), torch.zeros(D, dtype=dtype, device=device),
             torch.zeros(D, D, dtype=dtype, device=device))
    S = _block_starts(tuple(x[-1] for x in E_pows), B, _combine_affine, ident)
    prior = (torch.zeros(1, D, D, dtype=dtype, device=device), x0.mean[None].to(dtype),
             symmetrize(x0.cov)[None].to(dtype))
    St = _combine_affine(prior, S)
    X = _combine_affine(tuple(x[:, None] for x in St), tuple(x[None] for x in E_pows))
    return Gaussian(X[1].reshape(N, D), X[2].reshape(N, D, D))


def marginals_diag(model):
    """(means, variances) of the observations of a Fill model."""
    xs = latent_marginals(model)
    e = _single(model.emis)
    if isinstance(e, em.ScalarEmissions):
        return (xs.mean @ e.H + e.h,
                torch.einsum("i,nij,j->n", e.H, symmetrize(xs.cov), e.H) + e.s)
    H_eff, h_eff, R_kind, R_payload = _effective_emission(e)
    var = torch.einsum("ij,njk,ik->ni", H_eff, symmetrize(xs.cov), H_eff)
    return (xs.mean @ H_eff.T + h_eff,
            var + (R_payload if R_kind == "diag" else torch.diagonal(R_payload)))
