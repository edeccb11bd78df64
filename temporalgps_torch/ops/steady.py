"""The steady-state engine, engine="steady" (temporalgps_tpu/ops/steady.py).

For a Fill forward model (a RegularSpacing model, a regular grid's
space-time or pseudo-point model) the filtering covariance follows a
time-invariant Riccati recursion that converges geometrically to its fixed
point. This engine:

  1. runs the exact lti pipeline (ops/lti.py) on the first `n_warmup`
     steps;
  2. takes the converged filtering covariance by doubling the constant
     filtering element (`_steady_filter_cov`; for scalar emissions a Newton
     polish of the warmup's last covariance, `_refine_P_ss`) and uses it
     for every later step;
  3. solves the remaining mean recursion m_t = G m_{t-1} + w_t with a
     constant G by `affine_const_states`: one dense (B, L D) x (L D, L D)
     product within blocks and a log2(B)-level scan across them;
  4. sums the remaining lml terms with constant operators.

The constant operators (the converged covariance, the gain, the innovation
factors) are O(1) in size and formed in float64, then cast to the model's
dtype (`_steady_ops`): a relative error in log det S enters the lml N
times. The O(N) segment math stays in the model's dtype. Nothing of the
late segment keeps an (N, D, D) tensor, so the reverse-mode gradient (the
`torch.autograd.Function` of `affine_const_states`) keeps no O(N)
covariance residuals.

The approximation: every filtering covariance after step n_warmup is the
converged one. The error decays like rho^(2 n_warmup); the default 512
covers lambda dt >~ 0.01 (`suggest_warmup` gives a model's own). Opt-in
(engine="steady"). No missing data and no deterministic-diffusion blocks,
as ops/lti.py. The recursion's semantics are the sequential engine's; the
shortcut has no counterpart in the reference's Julia original.
"""

import math

import numpy as np
import torch

from ..config import POSTERIOR_JITTER, RAND_JITTER
from ..models import emissions as em
from ..utils import psd
from ..utils.fill import Fill, is_fill
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from . import lti
from .assoc import _combine_affine, _combine_filter

DEFAULT_WARMUP = 512

# The constant operators' dtype (`_steady_ops`), whatever the model's.
HI = torch.float64


def _mT(X):
    return X.transpose(-1, -2)


def _round_warmup(k, N, base=16):
    """A warmup length rounded up to a multiple of `base`, at most N: the
    warmup's blocked filter halves its block count until it divides k, and
    an odd k would leave one block of k sequential steps."""
    return min(-(-int(k) // base) * base, int(N))


def suggest_warmup(model, *, tol=1e-10) -> int:
    """The smallest k with rho^(2k) <= tol, rho the spectral radius of the
    constant transition (the open-loop bound on the filter's convergence),
    rounded up to a multiple of 64, in [64, len(model)]. Read on the host:
    one copy of A to the host, no other sync. Pass it as `n_warmup=`."""
    A0 = model.trans.As.value.detach().to("cpu", torch.float64).numpy()
    rho = float(np.max(np.abs(np.linalg.eigvals(A0))))
    if rho >= 1.0:
        raise ValueError(f"transition spectral radius {rho} >= 1: not a stable LTI model")
    k = int(np.ceil(np.log(tol) / (2.0 * np.log(rho))))
    return max(64, _round_warmup(k, len(model), base=64))


def _trim(model, k):
    """The same Fill model over its first k steps."""
    from ..models.gauss_markov import GaussMarkov
    from ..models.lgssm import LGSSM

    cut = lambda leaf: Fill(leaf.value, k) if is_fill(leaf) else leaf
    t = model.trans
    trans = GaussMarkov(As=cut(t.As), offs=cut(t.offs), Qs=cut(t.Qs), x0=t.x0, forward=t.forward)
    return LGSSM(trans, em.map_leaves(cut, model.emis))


def _levels(N, n_warmup):
    """The squarings that reach step 2^levels >= min(N, 8 n_warmup): by the
    engine's contract the recursion has converged below float64's rounding
    there."""
    return max(1, math.ceil(math.log2(max(min(N, 8 * (n_warmup or DEFAULT_WARMUP)), 2))))


def _steady_filter_cov(model, N, n_warmup=None):
    """The filtering covariance at t = 2^levels, in float64, by squaring
    the constant (data-free) filtering element."""
    D = model.latent_dim
    e0 = lti._const_element(model, HI)[0]
    z = torch.zeros(D, dtype=HI, device=model.device)
    E = (e0[0], z, e0[2], z, e0[4])
    for _ in range(_levels(N, n_warmup)):
        E = _combine_filter(E, E)
    x0, zz = model.trans.x0, torch.zeros(D, D, dtype=HI, device=model.device)
    prior = (zz, x0.mean.to(HI), symmetrize(x0.cov).to(HI), z, zz)
    return symmetrize(_combine_filter(prior, E)[2])


class _AffineConstStates(torch.autograd.Function):
    """`affine_const_states` with its adjoint: the adjoint of a
    constant-matrix affine recursion is the same recursion with G^T run
    backwards, lambda_t = mbar_t + G^T lambda_{t+1}, so the backward
    re-enters the forward schedule and keeps only the (M, D) states."""

    @staticmethod
    def forward(ctx, G, w, m0, block_len):
        m = _acs_impl(G, w, m0, block_len)
        ctx.save_for_backward(G, m0, m)
        ctx.block_len = block_len
        return m

    @staticmethod
    def backward(ctx, mbar):
        G, m0, m = ctx.saved_tensors
        lam = _acs_impl(G.T, mbar.flip(0), torch.zeros_like(m0), ctx.block_len).flip(0)
        m_prev = torch.cat([m0[None], m[:-1]])
        return lam.T @ m_prev, lam, G.T @ lam[0], None


def affine_const_states(G, w, m0, *, block_len=16):
    """The states m_t = G m_{t-1} + w_t, t = 1..M, from m0, G constant; w
    (M, D) -> (M, D). The powers G^0..G^L once; each block of L steps' sums
    as one dense (B, L D) x (L D, L D) product with the block-Toeplitz
    operator of the powers; the block starts by a log2(B)-level scan whose
    step is one (B, D) x (D, D) product; the expansion within blocks one
    (L D, D) x (D, B) product. Reverse mode runs `_AffineConstStates`'s
    adjoint (the Function takes no forward mode)."""
    return _AffineConstStates.apply(G, w, m0, block_len)


def _acs_impl(G, w, m0, block_len):
    M, D = w.shape
    L = min(block_len, M)
    B = -(-M // L)
    if B * L > M:
        w = torch.cat([w, w.new_zeros(B * L - M, D)])
    eye = torch.eye(D, dtype=w.dtype, device=w.device)
    Gp = [eye]
    for _ in range(L):
        Gp.append(G @ Gp[-1])
    Gp = torch.stack(Gp)                                          # G^0..G^L
    li = torch.arange(L, device=w.device)
    idx = li[:, None] - li[None, :]
    T = torch.where((idx >= 0)[:, :, None, None], Gp[idx.clamp(0, L)], 0.0)  # T[l, i] = G^(l-i)
    T2 = T.permute(0, 2, 1, 3).reshape(L * D, L * D)
    W = (w.reshape(B, L * D) @ T2.T).reshape(B, L, D)             # within-block sums
    # Block starts: m_start[b + 1] = G^L m_start[b] + W[b, L-1], m_start[0] = m0,
    # as the decayed inclusive prefix p[b] = sum_{i <= b} (G^L)^(b-i) h[i].
    GL = Gp[L]
    p = torch.cat([W[:1, L - 1] + GL @ m0, W[1:, L - 1]])
    P_lev, shift = GL, 1
    while shift < B:
        p = torch.cat([p[:shift], p[shift:] + p[:-shift] @ P_lev.T])
        P_lev, shift = P_lev @ P_lev, shift * 2
    m_start = torch.cat([m0[None], p[:-1]])
    lead = (Gp[1:].reshape(L * D, D) @ m_start.T).T.reshape(B, L, D)  # G^(l+1) m_start[b]
    return (lead + W).reshape(B * L, D)[:M]


def affine_const_states_multi(G, W, m0, *, block_len=16):
    """The matrix-state recursion m_t = G m_{t-1} + W_t on (D, R) states, W
    (M, D, R), m0 (D, R) -> (M, D, R): one (R D)-state vector recursion with
    kron(I_R, G), column r's state at [r D, (r + 1) D)."""
    M, D, R = W.shape
    GF = torch.kron(torch.eye(R, dtype=G.dtype, device=G.device), G)
    out = affine_const_states(GF, W.transpose(1, 2).reshape(M, R * D), m0.T.reshape(R * D),
                              block_len=block_len)
    return out.reshape(M, R, D).transpose(1, 2)


def _refine_P_ss(model, P_seed, N, n_warmup):
    """A filtering-covariance seed polished to the Riccati fixed point in
    float64 by Newton's method (scalar emissions): F the one-step map and G
    its closed loop, F(P + X) ~ F(P) + G X G^T, so each step solves the
    Lyapunov equation X - G X G^T = F(P) - P by doubling. Three steps from a
    warmup's last covariance reach float64's rounding."""
    A = model.trans.As.value.to(HI)
    Q = symmetrize(model.trans.Qs.value.to(HI))
    e = lti._single(model.emis)
    H, s = e.H.to(HI), e.s.to(HI)
    levels = _levels(N, n_warmup)
    P = symmetrize(P_seed.to(HI))
    for _ in range(3):
        Pp = symmetrize(A @ P @ A.T + Q)
        K = (Pp @ H) / (H @ Pp @ H + s)
        Pn = symmetrize(Pp - K[:, None] * (H @ Pp)[None, :])
        Gj = A - K[:, None] * (H @ A)[None, :]
        X = symmetrize(Pn - P)
        for _ in range(levels):
            X, Gj = symmetrize(X + Gj @ X @ Gj.T), Gj @ Gj
        P = symmetrize(P + X)
    return P


def _steady_ops(model, dtype, N, n_warmup=None, P_seed=None):
    """The constant late-segment operators from the converged covariance,
    in float64 (HI), cast to `dtype`; the float64 P_ss, P_pred and A also as
    `*_hi` for the smoother's constant gain. `P_seed` (scalar emissions)
    seeds `_refine_P_ss` in place of the squaring chain."""
    if P_seed is not None and isinstance(model.emis, em.ScalarEmissions):
        P_ss = _refine_P_ss(model, P_seed, N, n_warmup)
    else:
        P_ss = _steady_filter_cov(model, N, n_warmup)
    t = model.trans
    A0, a0, Q0 = (leaf.value.to(HI) for leaf in (t.As, t.offs, t.Qs))
    P_pred = symmetrize(A0 @ P_ss @ A0.T + Q0)
    e = lti._single(model.emis)
    out = dict(A0=A0, a0=a0, P_ss=P_ss, P_pred=P_pred)
    if isinstance(e, em.ScalarEmissions):
        H, h, s = e.H.to(HI), e.h.to(HI), e.s.to(HI)
        S = H @ P_pred @ H + s
        K = (P_pred @ H) / S
        out.update(H=H, h=h, S=S, K=K, G=A0 - K[:, None] * (H @ A0)[None, :],
                   c_w=a0 - K * (H @ a0 + h), logdetS=torch.log(S))
    else:
        H_eff, h_eff, R_kind, R_payload = lti._effective_emission(e)
        H_eff, h_eff, R = H_eff.to(HI), h_eff.to(HI), R_payload.to(HI)
        R = torch.diag(R) if R_kind == "diag" else R
        Dout = H_eff.shape[0]
        Ls = psd.cholesky(symmetrize(H_eff @ P_pred @ H_eff.T + R))
        S_inv = psd.chol_solve(Ls, torch.eye(Dout, dtype=HI, device=Ls.device))
        K = P_pred @ (H_eff.T @ S_inv)
        out.update(H_eff=H_eff, h_eff=h_eff, S_inv=S_inv, K=K, G=A0 - K @ (H_eff @ A0),
                   c_w=a0 - K @ (H_eff @ a0 + h_eff),
                   logdetS=2.0 * torch.log(torch.diagonal(Ls)).sum(), Dout=Dout)
    cast = {k: v.to(dtype) if torch.is_tensor(v) else v for k, v in out.items()}
    cast.update(P_ss_hi=P_ss, P_pred_hi=P_pred, A0_hi=A0, scalar=isinstance(e, em.ScalarEmissions))
    return cast


def _check(model):
    if not lti.supported(model):
        raise ValueError("engine='steady' requires a forward model with all-Fill "
                         "(time-invariant) transition and emission parameters")


def _hi_mode(model):
    """The warmup covariance pass's precision, by state dim as the
    reference's: "full" float64 for D <= 8 (~4e-5 relative float32
    gradients there), "chain" above (the power chain alone in float64)."""
    return "full" if model.latent_dim <= 8 else "chain"


def _filter_steady(model, y, k, *, n_blocks=None):
    """The hybrid filter of logpdf and the smoother: the exact warmup `q`
    (lti._filter_pass on the first k steps), the constant operators `ops`,
    the late filtering means and the late predicted means."""
    dtype = model.trans.x0.mean.dtype
    y = y.to(dtype)
    B_w = 16
    while k % B_w:
        B_w //= 2
    q = lti._filter_pass(_trim(model, k), y[:k], n_blocks=n_blocks or B_w,
                         cov_hi=_hi_mode(model))
    m_start = q["means"][-1]
    scalar = isinstance(model.emis, em.ScalarEmissions)
    ops = _steady_ops(model, dtype, len(model), n_warmup=k,
                      P_seed=q["P_f"][-1] if scalar else None)
    y_late = y[k:]
    if ops["scalar"]:
        w = ops["c_w"][None, :] + y_late[:, None] * ops["K"][None, :]  # c_w carries -K h
    else:
        w = ops["c_w"][None, :] + y_late @ ops["K"].T
    means_late = affine_const_states(ops["G"], w, m_start)
    m_prev_late = torch.cat([m_start[None], means_late[:-1]])
    return dict(q=q, ops=ops, y=y, y_late=y_late, m_start=m_start, means_late=means_late,
                m_pred_late=m_prev_late @ ops["A0"].T + ops["a0"], dtype=dtype)


def logpdf(model, y, *, n_warmup=None, n_blocks=None):
    """lml of a Fill forward model, the steady-state approximation after the
    first n_warmup (default 512) exactly filtered steps; with n_warmup >= N
    the lti engine's, exactly."""
    _check(model)
    N = len(model)
    k = _round_warmup(n_warmup or DEFAULT_WARMUP, N)
    if k >= N:
        return lti.logpdf(model, y, n_blocks=n_blocks)
    f = _filter_steady(model, y, k, n_blocks=n_blocks)
    ops, y_late, m_pred = f["ops"], f["y_late"], f["m_pred_late"]
    n_late = N - k
    if ops["scalar"]:
        r = y_late - (m_pred @ ops["H"] + ops["h"])
        lp_late = -0.5 * (n_late * (ops["logdetS"] + math.log(2.0 * math.pi))
                          + (r * r).sum() / ops["S"])
    else:
        r = y_late - (m_pred @ ops["H_eff"].T + ops["h_eff"])
        lp_late = -0.5 * (n_late * (ops["logdetS"] + ops["Dout"] * math.log(2.0 * math.pi))
                          + (r * (r @ ops["S_inv"].T)).sum())
    return lti._lml_from_filter(f["q"]) + lp_late


def _prior_cov_segments(model, N, k, dtype):
    """(P_early (min(k, N), D, D), P_ss (D, D) or None when k >= N): the
    exact prior covariances of the first k steps and the converged fixed
    point (by squaring the affine map in float64)."""
    D = model.latent_dim
    t = model.trans
    A0, Q0 = t.As.value.to(dtype), symmetrize(t.Qs.value.to(dtype))
    E_pows = lti._all_powers((A0, torch.zeros(D, dtype=dtype, device=A0.device), Q0), k,
                             _combine_affine)
    P0 = symmetrize(t.x0.cov).to(dtype)
    At = E_pows[0]
    P_early = symmetrize(At @ P0 @ _mT(At) + E_pows[2])
    if k >= N:
        return P_early[:N], None
    E = tuple(x[-1].to(HI) for x in E_pows)
    for _ in range(max(1, math.ceil(math.log2(max(N // max(k, 1), 2))))):
        E = _combine_affine(E, E)
    return P_early, symmetrize(E[0] @ P0.to(HI) @ E[0].T + E[2]).to(dtype)


def _prior_means(model, N, dtype):
    t = model.trans
    D = model.latent_dim
    return affine_const_states(t.As.value.to(dtype), t.offs.value.to(dtype).expand(N, D),
                               t.x0.mean.to(dtype))


def latent_marginals(model, *, n_warmup=None) -> Gaussian:
    """Prior latent marginals: the means exact (the constant-matrix affine
    recursion), the covariances exact for the first n_warmup steps and the
    converged value after (this materialises (N, D, D); marginals_diag does
    not)."""
    _check(model)
    N = len(model)
    k = _round_warmup(n_warmup or DEFAULT_WARMUP, N)
    dtype = model.dtype
    D = model.latent_dim
    P_early, P_ss = _prior_cov_segments(model, N, k, dtype)
    covs = P_early if P_ss is None else torch.cat([P_early, P_ss.expand(N - k, D, D)])
    return Gaussian(_prior_means(model, N, dtype), covs)


def _project_segments(e, means, P_head, P_mid, n_mid, P_tail=None):
    """(means, variances) of the observations of latent means (N, D) and
    covariances given by segments: (n, D, D) head, one (D, D) value for
    n_mid steps, an optional (n, D, D) tail; no (N, D, D) tensor."""
    if isinstance(e, em.ScalarEmissions):
        H, h, s = e.H, e.h, e.s
        quad = lambda P: torch.einsum("i,nij,j->n", H, P, H)
        v_mid = (H @ P_mid @ H).expand(n_mid) if P_mid is not None else None
        mu, noise = means @ H + h, s
    else:
        H, h_eff, R_kind, R_payload = lti._effective_emission(e)
        quad = lambda P: torch.einsum("ij,njk,ik->ni", H, P, H)
        v_mid = (torch.einsum("ij,jk,ik->i", H, P_mid, H).expand(n_mid, H.shape[0])
                 if P_mid is not None else None)
        mu, noise = means @ H.T + h_eff, (R_payload if R_kind == "diag"
                                          else torch.diagonal(R_payload))
    parts = [quad(P_head)] + ([v_mid] if v_mid is not None else []) + (
        [quad(P_tail)] if P_tail is not None else [])
    return mu, torch.cat(parts) + noise


def marginals_diag(model, *, n_warmup=None):
    """(means, variances) of the observations under the steady prior; the
    variances by segments, with no (N, D, D) latent covariance (3.6 GB at
    N = 1M, D = 30)."""
    _check(model)
    N = len(model)
    k = _round_warmup(n_warmup or DEFAULT_WARMUP, N)
    dtype = model.dtype
    P_early, P_ss = _prior_cov_segments(model, N, k, dtype)
    e = em.map_leaves(lambda v: v.to(dtype), lti._single(model.emis))
    return _project_segments(e, _prior_means(model, N, dtype), P_early, P_ss, N - k)


def rand_with_eps(model, eps_t, eps_e, x_init):
    """The exact joint sample of a Fill model from given normals (the
    contract of the other engines' rand_with_eps): x_t = A x_{t-1} + a +
    chol(Q + RAND_JITTER I) eps_t is a constant-matrix affine recursion
    (`affine_const_states`), the factor `psd.sample_factor`'s as the
    sequential engine's."""
    dtype = x_init.dtype
    t = model.trans
    A0, a0, Q0 = (leaf.value.to(dtype) for leaf in (t.As, t.offs, t.Qs))
    w = a0 + eps_t @ psd.sample_factor(Q0, RAND_JITTER).T
    xs = affine_const_states(A0, w, x_init)
    return em.step_conditional_rand(eps_e, xs, lti._single(model.emis))


def _smoothed_cov_fixed_point(J_ss, C_mid, N):
    """The fixed point of the backward covariance map X -> J X J^T + C, by
    doubling the affine map."""
    Jp, Cp = J_ss, C_mid
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        Cp = symmetrize(Jp @ Cp @ Jp.T + Cp)
        Jp = Jp @ Jp
    return Cp


def posterior_marginals_diag(model, y, *, emis=None, n_warmup=None, n_blocks=None):
    """Smoothed (means, variances) of the observations of a Fill model, the
    steady counterpart of marginals_diag(posterior(model, y)). The smoothed
    covariance converges backwards to its own fixed point: an exact head
    (the first n_warmup steps, per-step gains), a constant middle, and a
    tail of ~n_warmup steps from the filter's end with the constant gain.
    `emis` replaces the emissions for prediction at new outputs (all-Fill
    leaves; the pseudo-point posterior). No missing data. At N <= max(2 k,
    64) the exact lti smoother."""
    from ..models import lgssm as lg
    from ..models.lgssm import LGSSM

    _check(model)
    N = len(model)
    k = _round_warmup(n_warmup or DEFAULT_WARMUP, N)
    emis_use = emis if emis is not None else model.emis
    if N <= max(2 * k, 64):
        post = lti.posterior(model, y, n_blocks=n_blocks, cov_hi=_hi_mode(model))
        return lg.marginals_diag(LGSSM(post.trans, emis_use), engine="sequential")

    f = _filter_steady(model, y, k, n_blocks=n_blocks)
    q, ops, dtype = f["q"], f["ops"], f["dtype"]
    A0 = ops["A0"]
    kt = min(k, N - k)  # the tail; the middle is N - k - kt >= 0

    # Gains: exact in the head, J_t = P_f[t] A^T P_pred[t+1]^{-1}; the
    # constant one in float64 (a bias in it drifts the whole late segment).
    P_pred_next_head = torch.cat([q["P_pred"][1:], ops["P_pred"][None]])
    Lp = psd.cholesky(psd.add_jitter(P_pred_next_head, POSTERIOR_JITTER))
    J_head = _mT(psd.chol_solve(Lp, A0 @ q["P_f"]))
    Lps = psd.cholesky(psd.add_jitter(ops["P_pred_hi"], POSTERIOR_JITTER))
    J_ss_hi = _mT(psd.chol_solve(Lps, ops["A0_hi"] @ ops["P_ss_hi"]))
    J_ss = J_ss_hi.to(dtype)

    # Smoothed means: the late segment backwards with the constant gain, the
    # head backwards with its own gains.
    means_late, m_pred_late = f["means_late"], f["m_pred_late"]
    w_mid = means_late[:-1] - m_pred_late[1:] @ J_ss.T
    u = affine_const_states(J_ss, w_mid.flip(0), means_late[-1])
    ms_late = torch.cat([u.flip(0), means_late[-1:]])
    m_pred_next_head = torch.cat([q["m_pred"][1:], m_pred_late[:1]])
    w_head = q["means"] - torch.einsum("tij,tj->ti", J_head, m_pred_next_head)
    ms_head = lti.affine_means(J_head.flip(0), w_head.flip(0), ms_late[0]).flip(0)
    means_s = torch.cat([ms_head, ms_late])

    # Smoothed covariances by segments: the constant middle's fixed point,
    # the tail from the filter's converged state, the head backwards.
    C_mid_hi = symmetrize(ops["P_ss_hi"] - J_ss_hi @ ops["P_pred_hi"] @ J_ss_hi.T)
    P_s_ss = _smoothed_cov_fixed_point(J_ss_hi, C_mid_hi, N).to(dtype)
    C_mid = C_mid_hi.to(dtype)
    P = ops["P_ss"]
    tail = [P]
    for _ in range(kt - 1):
        P = symmetrize(C_mid + J_ss @ P @ J_ss.T)
        tail.append(P)
    P_tail = torch.stack(tail[::-1])  # t = N - kt .. N - 1
    P = P_s_ss
    head = []
    for t in range(k - 1, -1, -1):
        J_t = J_head[t]
        P = symmetrize(q["P_f"][t] + J_t @ (P - P_pred_next_head[t]) @ J_t.T)
        head.append(P)
    P_head = torch.stack(head[::-1])  # t = 0 .. k - 1

    e = em.map_leaves(lambda v: v.to(dtype), lti._single(emis_use))
    mid_len = N - k - kt
    return _project_segments(e, means_s, P_head, P_s_ss if mid_len else None, mid_len, P_tail)
