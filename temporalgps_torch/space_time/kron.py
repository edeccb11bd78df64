"""The Kronecker-factored space-time engine (temporalgps_tpu/space_time/kron.py).

The exact grid compiler (to_gauss_markov.py) materialises

    A = I_Ns (x) A_t,   Q = Kr (x) Q_t,   H = I_Ns (x) h_t^T

and its engines run the dense recursion in the D = Ns * Dt state, O(Ns^3
Dt^3) a step. This engine keeps the factors. The state mean is m (Dt, Ns)
and its covariance P (Dt, Dt, Ns, Ns), the temporal component axes first
and the (Ns, Ns) spatial tiles last, so that

    predict:  m' = A_t m + a_t,  P' = A_t . P . A_t^T + Q_t (x) Kr     O(Ns^2 Dt^3)
    update:   S = h^T P' h + diag(s) (Ns x Ns), its Cholesky factor,
              the gain and the downdate                              O(Ns^3 + Ns^2 Dt^2)

Each step is about a dozen tensor ops: a GEMM by kron(A_t, A_t) for the
predict, one for h's projections of P' (P' h and S), the Cholesky factor of
S, one triangular solve for the gain rows, the residual and the lml
together, and one GEMM for the downdate. On a card the loop is host-bound
(PERF.md); takes_engine_none below says where engine=None takes it there.

Scope, as the reference's: a (possibly Scaled) Separable kernel on a
RectilinearGrid with a ZeroMean or ConstMean, any noise; NaN in y is a
missing observation (the large-variance fill of models/missings.py). The
gp verbs route here with engine="kron" (gp/lti_sde._route_kron). Outputs are
in time form (Nt, Ns); the verbs flatten them.

The innovation factors are taken with `cholesky_ex` and their status read
once after the loop, so the host queues the whole recursion without waiting
for the device at each step; a factor that failed raises there.
"""

import math
from typing import Any, NamedTuple

import torch

from ..config import POSTERIOR_JITTER
from ..gp import kernels as K
from ..gp import lti_sde
from ..gp.means import ConstMean, ZeroMean
from ..models.missings import fill_in_missings, volume_compensation
from ..utils import psd
from ..utils.fill import is_fill, tmaterialize
from . import grids
from .separable import Separable, spatial_gram

# engine=None's rule on a CUDA card (takes_engine_none, gp/lti_sde.
# _route_kron), from probes/torch_kron_crossover.py on "NVIDIA H100 80GB
# HBM3, 700.00 W": c4's model, Dt = 3, median ms of 5 calls (range), kron
# against "parallel"; x: "parallel" raises (its float32 covariances are not
# positive definite):
#
#     Ns x Nt, dtype     logpdf                        posterior marginals
#     50 x 100   f32     67 (57-75) vs 45 (44-48)      73 (69-77) vs 55 (53-58)
#                f64     66 (64-76) vs 32 (31-37)      98 (78-101) vs 42 (39-45)
#     100 x 100  f32     48 (42-50) vs 62 (59-63)      91 (55-95) vs 70 (59-80)
#                f64     44 (41-56) vs 51 (49-55)      60 (57-87) vs 63 (62-63)
#     150 x 100  f32     66 (54-84) vs 84 (82-86)      97 (71-98) vs x
#                f64     59 (45-60) vs 86 (84-88)      64 (62-70) vs 99 (97-100)
#     200 x 100  f32     53 (47-55) vs 138 (136-143)   75 (69-85) vs x
#                f64     54 (48-87) vs 147 (145-150)   80 (73-97) vs 165 (154-169)
#     247 x 100  f32     58 (56-62) vs 215 (209-224)   85 (79-88) vs x
#                f64     64 (56-72) vs 241 (233-245)   83 (77-87) vs 276 (265-278)
#     50 x 1000  f32     514 (461-694) vs 68 (65-77)   702 (689-818) vs 98 (79-100)
#                f64     538 (448-604) vs 74 (73-75)   838 (602-929) vs 77 (75-81)
#     100 x 1000 f32     411 (406-566) vs 175 (168-183)  517 (492-814) vs 232 (228-233)
#                f64     491 (396-642) vs 176 (175-178)  637 (585-797) vs 217 (212-221)
#     150 x 1000 f32     659 (637-792) vs 380 (379-385)  742 (623-755) vs x
#                f64     390 (360-424) vs 418 (408-419)  671 (653-797) vs 541 (537-555)
#     200 x 1000 f32     535 (446-677) vs 719 (710-723)  920 (867-960) vs x
#                f64     645 (418-722) vs 729 (722-743)  688 (659-739) vs 932 (926-941)
#     247 x 1000 f32     560 (479-601) vs 1224 (1191-1467)  876 (778-1007) vs x
#                f64     428 (389-565) vs 1294 (1279-1309)  931 (718-1239) vs 1709 (1687-1942)
#
# kron's steps are host-bound, "parallel"'s grow as D^3: from D = 600 (200
# points) kron's median wins every call measured, at either length and
# dtype, and below it "parallel" wins at least one. A float32 model's
# posterior marginals and rand take kron from D = 300 (100 points), whatever
# the speed: "parallel"'s float32 posterior raised from D = 375 (125 x
# 1000; passed at 150, 225 and 300), "block"'s from 600, "parallel"'s prior
# rand at 741, and kron's, which forms its products in float64 from the
# float32 factors, factors at every shape above.
MIN_D_ON_CARD = 600
MIN_D_FLOAT32_POSTERIOR_ON_CARD = 300


def takes_engine_none(fx, verb) -> bool:
    """Whether engine=None takes this engine for `verb` ("logpdf",
    "marginals", "rand" or "posterior") of a supported model on a CUDA card:
    from MIN_D_ON_CARD latent states, and a float32 model's "posterior" and
    "rand" from MIN_D_FLOAT32_POSTERIOR_ON_CARD (the measurements above)."""
    f = fx.f
    D = fx.x.xl.shape[0] * K.state_dim(_unwrap_scaled(f.f.kernel)[1].r)
    if lti_sde._storage_dtype(f.storage) == torch.float32 and verb in ("posterior", "rand"):
        return D >= MIN_D_FLOAT32_POSTERIOR_ON_CARD
    return D >= MIN_D_ON_CARD


def _unwrap_scaled(kernel):
    """Peel Scaled wrappers: (the product of their sigma2, the core kernel).
    sigma2 * k scales the emission row by sigma."""
    sigma2 = 1.0
    while isinstance(kernel, K.Scaled):
        sigma2 = sigma2 * kernel.sigma2
        kernel = kernel.kernel
    return sigma2, kernel


def supports(fx) -> bool:
    """Whether fx is a (possibly Scaled) Separable model with a ZeroMean or
    ConstMean on a RectilinearGrid."""
    return (
        isinstance(getattr(fx, "x", None), grids.RectilinearGrid)
        and isinstance(_unwrap_scaled(fx.f.f.kernel)[1], Separable)
        and isinstance(fx.f.f.mean, (ZeroMean, ConstMean))
    )


class _Factors(NamedTuple):
    As: Any      # temporal per-step leaves: Fill or (Nt, ...)
    offs: Any
    Qs: Any
    Hs: Any
    hs: Any
    Kr: torch.Tensor     # (Ns, Ns) spatial gram with the dtype's jitter
    x0: Any              # the temporal prior, Gaussian (Dt,), (Dt, Dt)
    noise: torch.Tensor  # (Nt, Ns) observation variances
    dtype: torch.dtype
    AA: Any      # kron(A_t, A_t) (Dt^2, Dt^2) per step: the predict's left factor
    QK: Any      # Q_t (x) Kr as (Dt^2, Ns^2) per step: the process noise
    HH: Any      # [I (x) h_t^T; h_t^T (x) h_t^T] (Dt + 1, Dt^2) per step: the update's
                 # left factor, giving P' h (Dt rows) and h^T P' h (the last)


def _factors(fx) -> _Factors:
    f = fx.f
    dtype, device = lti_sde._storage_dtype(f.storage), f.device
    sigma2, kernel = _unwrap_scaled(f.f.kernel)
    if not isinstance(kernel, Separable):
        raise TypeError("kron engine requires a (possibly Scaled) Separable kernel")
    x = fx.x
    Nt = grids.n_time(x)
    As, offs, Qs, (Hs, hs), x0 = lti_sde.lgssm_components(kernel.r, grids.get_times(x), dtype,
                                                          device)
    if not isinstance(sigma2, float) or sigma2 != 1.0:
        sigma = torch.sqrt(torch.as_tensor(sigma2, dtype=dtype, device=device))
        Hs = lti_sde._combine_leaves(lambda H: sigma * H, [Hs], Nt)
        hs = lti_sde._combine_leaves(lambda h: sigma * h, [hs], Nt)
    if isinstance(f.f.mean, ConstMean):
        c = torch.as_tensor(f.f.mean.c, dtype=dtype, device=device)
        hs = lti_sde._combine_leaves(lambda h: h + c, [hs], Nt)
    noise = fx.noise
    flat = noise.value.expand(noise.N) if is_fill(noise) else noise
    Kr = spatial_gram(kernel, x, dtype, device)
    AA = lti_sde._combine_leaves(lambda A: K._batched_kron(A, A), [As], Nt)
    QK = lti_sde._combine_leaves(
        lambda Q: Q.reshape(*Q.shape[:-2], -1, 1) * Kr.reshape(-1), [Qs], Nt)
    eye = torch.eye(x0.mean.shape[-1], dtype=dtype, device=device)
    HH = lti_sde._combine_leaves(
        lambda H: torch.cat([K._batched_kron(eye, H[..., None, :]),
                             K._batched_kron(H[..., None, :], H[..., None, :])], dim=-2),
        [Hs], Nt)
    return _Factors(As, offs, Qs, Hs, hs, Kr, x0, grids.noise_var_to_time_form(x, flat), dtype,
                    AA, QK, HH)


def _prior(fac: _Factors):
    """(m0 (Dt, Ns), P0 (Dt, Dt, Ns, Ns)) of x0 (x) Kr."""
    Dt, Ns = fac.x0.mean.shape[-1], fac.Kr.shape[0]
    m0 = fac.x0.mean[:, None].expand(Dt, Ns).to(fac.dtype)
    P0 = (psd.symmetrize(fac.x0.cov)[:, :, None, None] * fac.Kr).to(fac.dtype)
    return m0, P0


def _per_step(*leaves):
    """Each step's values of Fill or (Nt, ...) leaves, zipped."""
    return zip(*(tmaterialize(leaf).unbind(0) for leaf in leaves))


def _predict(m, P, A, a, AA, QK):
    """m' = A m + a; P' = (A (x) A) P + Q (x) Kr, one GEMM on P viewed
    (Dt^2, Ns^2)."""
    Dt, Ns = m.shape
    return (torch.addmm(a[:, None], A, m),
            torch.addmm(QK, AA, P.view(Dt * Dt, Ns * Ns)).view(Dt, Dt, Ns, Ns))


def _symmetrized(P):
    """(P[a, b] + P[b, a]^T) / 2: keeps the (s, t) symmetry of the full
    covariance (to the last bit, lerp rounding apart)."""
    return torch.lerp(P, P.permute(1, 0, 3, 2), 0.5)


def _update(m_p, P_p, h, HH, y_c, sd):
    """One step's update in factored form, y_c the observations less the
    emission offset: (m_f, P_f, the innovation factor's diagonal, the
    whitened residual z, the factor's status). The step's lml is
    -0.5 (Ns log 2 pi + 2 sum log diag(L) + z^T z)."""
    Dt, Ns = m_p.shape
    # Rows PHt[a] = sum_b h_b P'[a, b], then h^T P' h, in one GEMM.
    M = HH @ P_p.view(Dt * Dt, Ns * Ns)
    S = M[Dt].view(Ns, Ns)                        # the factor reads its lower triangle
    S.diagonal().add_(sd)
    L, info = torch.linalg.cholesky_ex(S)
    resid = torch.addmv(y_c, m_p.T, h, alpha=-1)
    # One solve for the gain rows and the residual: the rows of
    # [PHt[0]; ...; PHt[Dt-1]; resid^T] L^{-T} are V[:, (a, s)] = (L^{-1}
    # PHt[a]^T)[:, s], and z = L^{-1} resid.
    W = torch.linalg.solve_triangular(
        L.mT, torch.cat([M[:Dt].view(Dt * Ns, Ns), resid[None]]), upper=True, left=False)
    Vt, z = W[:-1], W[-1]                                          # Vt = V^T
    m_f = torch.addmv(m_p.reshape(-1), Vt, z).view(Dt, Ns)
    # The downdate P'[a, b] - V[:, a]^T V[:, b] for all (a, b) in one GEMM.
    P_f = P_p - (Vt @ Vt.T).view(Dt, Ns, Dt, Ns).permute(0, 2, 1, 3)
    return m_f, _symmetrized(P_f), L.diagonal(), z, info


def _check_factors(infos):
    if infos and bool(torch.stack(infos).ne(0).any()):
        raise torch.linalg.LinAlgError(
            "kron: an innovation covariance is not positive definite")


def _observations(fac: _Factors, x, y):
    """(filled noise, filled y, the number missing), time form."""
    y_tf = grids.observations_to_time_form(
        x, torch.as_tensor(y, dtype=fac.dtype, device=fac.Kr.device))
    return fill_in_missings(fac.noise, y_tf)


def _filter(fac: _Factors, y_f, sd):
    """The factored Kalman filter: yields each step's (m_f, P_f, diag(L),
    z), and raises once exhausted if a factor failed."""
    m, P = _prior(fac)
    y_c = y_f - tmaterialize(fac.hs)[:, None]
    infos = []
    for (A, a, AA, QK, h, HH), yt, st in zip(
            _per_step(fac.As, fac.offs, fac.AA, fac.QK, fac.Hs, fac.HH), y_c, sd):
        m, P = _predict(m, P, A, a, AA, QK)
        m, P, diag_L, z, info = _update(m, P, h, HH, yt, st)
        infos.append(info)
        yield m, P, diag_L, z
    _check_factors(infos)


def logpdf(fx, y):
    """Log marginal likelihood of a flat y (space fastest) on the grid; NaN
    = missing, as on the materialised engines."""
    fac = _factors(fx)
    sd, y_f, n_missing = _observations(fac, fx.x, y)
    steps = [(d, z) for _, _, d, z in _filter(fac, y_f, sd)]
    diag_L, z = (torch.stack(t) for t in zip(*steps))
    lml = -0.5 * (z.numel() * math.log(2 * math.pi) + 2 * torch.log(diag_L).sum()
                  + (z * z).sum())
    return lml + volume_compensation(n_missing, fac.dtype)


def marginals(fx):
    """Prior marginal (means, variances) of every observation, the noise
    included, in time form (Nt, Ns): the predict-only recursion,
    O(Ns^2 Dt^4) a step against the materialised O(Ns^3 Dt^3)."""
    fac = _factors(fx)
    m, P = _prior(fac)
    Dt, Ns = m.shape
    H = tmaterialize(fac.Hs)
    ms, variances = [], []
    for A, a, AA, QK, HH in _per_step(fac.As, fac.offs, fac.AA, fac.QK, fac.HH):
        m, P = _predict(m, P, A, a, AA, QK)
        ms.append(m)
        # sum_{a, b} h_a h_b P'[a, b, s, s]: the (Ns^2) axis's diagonal.
        variances.append(HH[Dt] @ P.view(Dt * Dt, Ns * Ns)[:, ::Ns + 1])
        P = _symmetrized(P)
    means = torch.einsum("ta,tas->ts", H, torch.stack(ms)) + tmaterialize(fac.hs)[:, None]
    return means, torch.stack(variances) + fac.noise


def _rand(fac: _Factors, z0, eps_t, eps_e):
    """Joint prior samples in time form (..., Nt, Ns) from standard normals
    z0 (..., Dt, Ns), eps_t (..., Nt, Dt, Ns), eps_e (..., Nt, Ns), batched
    over the leading axes. The factors stay apart: chol(Q_t (x) Kr) =
    root(Q_t) (x) chol(Kr), so a step's noise is two thin matmuls, here
    batched over all steps before the recursion, which runs the draws side
    by side as columns: x (Dt, n * Ns)."""
    L_Kr = psd.cholesky(fac.Kr)
    Nt, Ns = fac.noise.shape
    Dt = z0.shape[-2]
    lead = z0.shape[:-2]
    cols = lambda t: t.reshape(-1, *t.shape[len(lead):]).movedim(0, -2).flatten(-2)
    Lq = tmaterialize(lti_sde._combine_leaves(psd.psd_root, [fac.Qs], Nt))
    noise = torch.einsum("tij,...tjs->...tis", Lq, eps_t) @ L_Kr.T     # (..., Nt, Dt, Ns)
    c = cols(noise) + tmaterialize(fac.offs)[:, :, None]               # (Nt, Dt, n * Ns)
    x = fac.x0.mean[:, None] + cols(psd.psd_root(fac.x0.cov).to(fac.dtype) @ z0 @ L_Kr.T)
    states = []
    for A, c_t in zip(tmaterialize(fac.As).unbind(0), c):
        x = torch.addmm(c_t, A, x)
        states.append(x)
    f = torch.einsum("ta,tac->tc", tmaterialize(fac.Hs), torch.stack(states))
    f = f.view(Nt, -1, Ns).movedim(1, 0).reshape(*lead, Nt, Ns)
    return f + tmaterialize(fac.hs)[:, None] + torch.sqrt(fac.noise) * eps_e


def rand_with_eps(fx, z0, eps_t, eps_e):
    """`rand` on given standard normals (z0, eps_t, eps_e), for parity
    tests."""
    return _rand(_factors(fx), z0, eps_t, eps_e)


def rand(generator, fx, n=None):
    """A joint prior sample of the observations on the grid, noise included,
    in time form (Nt, Ns); `n` draws stacked on a leading axis. The normals
    come from `generator`, a torch.Generator on the model's device, drawn up
    front for each draw in turn: z0 (Dt, Ns), then eps_t (Nt, Dt, Ns), then
    eps_e (Nt, Ns). The draws share one batched recursion."""
    fac = _factors(fx)
    Nt, Ns = fac.noise.shape
    Dt = fac.x0.mean.shape[-1]
    draw = lambda *shape: torch.randn(shape, generator=generator, dtype=fac.dtype,
                                      device=fac.Kr.device)
    eps = [(draw(Dt, Ns), draw(Nt, Dt, Ns), draw(Nt, Ns)) for _ in range(n or 1)]
    ys = _rand(fac, *(torch.stack(e) for e in zip(*eps)))
    return ys[0] if n is None else ys


def _to_dense(P):
    """(..., Dt, Dt, Ns, Ns) -> (..., Ns*Dt, Ns*Dt), space-major: [..., a,
    b, s, t] goes to [..., s*Dt + a, t*Dt + b], the materialised model's
    ordering (I_Ns (x) A_t)."""
    *lead, Dt, _, Ns, _ = P.shape
    n = len(lead)
    return P.permute(*range(n), n + 2, n, n + 3, n + 1).reshape(*lead, Ns * Dt, Ns * Dt)


def posterior_marginals(fx, y, *, noise_pred=None):
    """Smoothed marginal (means, variances) of the observations in time form
    (Nt, Ns): the factored counterpart of the posterior's marginals on the
    materialised grid model.

    The hybrid smoother of the reference: the filter runs factored and keeps
    each step's (m_f, P_f); the gains J_t = P_f[t] A^T P_p[t+1]^{-1} come
    from one batched (Nt-1, D, D) Cholesky; the backward recursion is dense,
    two (D, D) products a step, and keeps only each step's observation-space
    means and variances. (A fully factored smoother is blocked: P_p =
    (I (x) A) P_f (I (x) A)^T + Kr (x) Q has no Kronecker structure, since
    P_f is general.) The predictions and the gains are formed in float64,
    whatever the model's dtype, the predicted covariances carrying
    POSTERIOR_JITTER, and stored in the model's dtype: a float32 P_p at
    D = Ns * Dt = 150 is not positive definite to float32's precision (the
    reversal of the other engines, models/lgssm.posterior, is formed in
    float64 for the same reason).

    Memory: about 6 x Nt x D^2 values at once (float64 for the gains).
    `noise_pred`: (Nt, Ns) observation variances reported in place of the
    filled training noise (the prediction noise). NaN in y is missing.
    """
    return _posterior_marginals(_factors(fx), fx.x, y, noise_pred)


def _posterior_marginals(fac: _Factors, x, y, noise_pred):
    dtype, wide = fac.dtype, torch.float64
    sd, y_f, _ = _observations(fac, x, y)
    steps = [(m, P) for m, P, _, _ in _filter(fac, y_f, sd)]
    m_f = torch.stack([m for m, _ in steps])                        # (Nt, Dt, Ns)
    P_f = torch.stack([P for _, P in steps])                        # (Nt, Dt, Dt, Ns, Ns)
    del steps
    Nt, Dt, Ns = m_f.shape
    D = Ns * Dt

    # The predictions of steps 1..Nt-1 from the filter's states, and the gains.
    A1, a1, Q1 = (tmaterialize(leaf)[1:].to(wide) for leaf in (fac.As, fac.offs, fac.Qs))
    AP = torch.einsum("nac,ncdst->nadst", A1, P_f[:-1].to(wide))  # A P_f, factored
    P_p = _to_dense(torch.einsum("nadst,nbd->nabst", AP, A1)
                    + Q1[..., None, None] * fac.Kr.to(wide))
    m_p = (A1 @ m_f[:-1].to(wide) + a1[..., None]).transpose(-1, -2).reshape(Nt - 1, D)
    Lp = psd.cholesky(psd.add_jitter(psd.symmetrize(P_p), POSTERIOR_JITTER))
    J = psd.chol_solve(Lp, _to_dense(AP)).transpose(-1, -2).to(dtype)
    del AP, Lp
    P_p, m_p = P_p.to(dtype), m_p.to(dtype)

    # The backward recursion m_s = m_f + J (m_s' - m_p), P_s = P_f + J (P_s'
    # - P_p) J^T, with the terms that do not involve the carry formed for all
    # steps at once: c = m_f - J m_p, C = P_f - J P_p J^T.
    P_f = _to_dense(P_f)
    m_f = m_f.transpose(-1, -2).reshape(Nt, D)
    c = m_f[:-1] - (J @ m_p[..., None])[..., 0]
    C = torch.baddbmm(P_f[:-1], J @ P_p, J.mT, alpha=-1)
    del P_p, m_p
    # Each step keeps the (Dt, Dt) diagonal blocks of P_s, [a, b, s] =
    # P_s[s Dt + a, s Dt + b].
    blocks = lambda P_d: torch.diagonal(P_d.reshape(Ns, Dt, Ns, Dt), dim1=0, dim2=2).clone()
    m_s, P_s = m_f[-1], P_f[-1]
    means, diag_blocks = [m_s], [blocks(P_s)]
    for t in range(Nt - 2, -1, -1):
        Jt = J[t]
        m_s = torch.addmv(c[t], Jt, m_s)
        P_s = torch.addmm(C[t], Jt @ P_s, Jt.T)
        P_s = torch.lerp(P_s, P_s.T, 0.5)
        means.append(m_s)
        diag_blocks.append(blocks(P_s))
    H = tmaterialize(fac.Hs)
    mus = torch.einsum("nsa,na->ns", torch.stack(means[::-1]).view(Nt, Ns, Dt), H)
    var = torch.einsum("na,nabs,nb->ns", H, torch.stack(diag_blocks[::-1]), H)
    sd_rep = sd if noise_pred is None else torch.as_tensor(noise_pred, dtype=dtype,
                                                           device=sd.device)
    return mus + tmaterialize(fac.hs)[:, None], var + sd_rep
