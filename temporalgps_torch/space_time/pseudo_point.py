"""Pseudo-point (DTC / ELBO) space-time models
(temporalgps_tpu/space_time/pseudo_point.py).

The state is the process at M spatial pseudo-inputs z: As = I_M (x) A_t,
Qs = K_zz (x) Q_t. BottleneckEmissions project the state to the inducing
space (H = I_M (x) h_t^T) and fan it out to each step's observations
(C = K_xz K_zz^{-1}), so every factor is M Dt- or M-dimensional whatever the
number of points observed a step. `dtc` is the lml of that model; `elbo`
adds Titsias' trace correction from the exact kernel's diagonal;
`approx_posterior_marginals(_at)` predict at new spatial points through the
same bottleneck, with the Nystrom residual as their noise.

Inputs: a RectilinearGrid (one C for all steps, a Fill) or a RegularInTime
(other points at each step: C per step, (Nt, max_n, M), the padding never
observed).
"""

import dataclasses
from typing import Any

import torch

from ..gp import kernels as K
from ..gp.lti_sde import GP, LTISDE, FiniteLTISDE, _combine_leaves, build_lgssm, lgssm_components
from ..gp.lti_sde import logpdf as gp_logpdf
from ..gp.means import ZeroMean
from ..models import lgssm as lgssm_mod
from ..models import missings as missings_mod
from ..models.emissions import BottleneckEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..utils import psd
from ..utils.fill import Fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.regular_spacing import num_times, time_array
from . import grids
from .separable import Separable, gram_diag_grid
from .to_gauss_markov import _kron


@dataclasses.dataclass(frozen=True, eq=False)
class DTCSeparable(K.Kernel):
    """A Separable kernel approximated through the spatial pseudo-inputs z
    ((M,) or (M, Dx))."""

    z: Any
    k: Separable


def dtcify(z, obj):
    """obj with every Separable kernel replaced by its DTCSeparable at z,
    through Scaled, Stretched, Sum, GP, LTISDE and FiniteLTISDE."""
    if isinstance(obj, Separable):
        return DTCSeparable(z, obj)
    if isinstance(obj, K.Scaled):
        return K.Scaled(dtcify(z, obj.kernel), obj.sigma2)
    if isinstance(obj, K.Stretched):
        return K.Stretched(dtcify(z, obj.kernel), obj.s)
    if isinstance(obj, K.Sum):
        return K.Sum(tuple(dtcify(z, c) for c in obj.kernels))
    if isinstance(obj, FiniteLTISDE):
        return FiniteLTISDE(dtcify(z, obj.f), obj.x, obj.noise)
    if isinstance(obj, LTISDE):
        return LTISDE(dtcify(z, obj.f), obj.storage, obj.device)
    if isinstance(obj, GP):
        return GP(dtcify(z, obj.kernel), obj.mean)
    raise TypeError(type(obj))


def contains_dtc(kernel) -> bool:
    if isinstance(kernel, DTCSeparable):
        return True
    if isinstance(kernel, (K.Scaled, K.Stretched)):
        return contains_dtc(kernel.kernel)
    if isinstance(kernel, (K.Sum, K.Product)):
        return any(contains_dtc(c) for c in kernel.kernels)
    return False


# ---------------------------------------------------------------------------
# The DTC state-space components
# ---------------------------------------------------------------------------

def _chol_z(space_kernel, z, dtype, eps):
    """(K_zz + eps' I, its Cholesky factor) in `dtype`, eps' the larger of
    eps and the dtype's jitter times the mean diagonal (the reference's
    float64 jitters are below float32's resolution)."""
    Kzz = K.gram(space_kernel, z)
    eps = torch.clamp_min(psd.dtype_jitter(dtype) * torch.diagonal(Kzz).mean(), eps)
    Kzz = (Kzz + eps * torch.eye(Kzz.shape[0], dtype=Kzz.dtype, device=Kzz.device)).to(dtype)
    return Kzz, psd.cholesky(Kzz)


def _kzz_solve(Lz, K):
    """K_zz^{-1} K for the (M, n) cross gram K of n points, through the
    inverse of the M x M factor: two GEMMs. A triangular solve of n = 1.5M
    columns (30k ragged steps of 50 points) took 21 s on the card and its
    backward 24 s, against 42 and 64 ms at n = 500k
    (probes/torch_c5_ragged.py, "NVIDIA H100 80GB HBM3, 700.00 W")."""
    Linv = psd.tri_solve(Lz, torch.eye(Lz.shape[0], dtype=Lz.dtype, device=Lz.device))
    return Linv.T @ (Linv @ K)


def _fan_out(sep, z, Lz, x, dtype):
    """C = K_xz K_zz^{-1}: (Ns, M) for a grid, (Nt, max_n, M) for a
    RegularInTime (one batched gram and solve over all steps)."""
    if isinstance(x, grids.RectilinearGrid):
        return psd.chol_solve(Lz, K.gram(sep.l, z, x.xl).to(dtype)).T
    vs = torch.as_tensor(x.vs_padded, device=Lz.device)
    Kzv = K.gram(sep.l, z, vs.flatten(0, 1)).to(dtype)                    # (M, Nt max_n)
    return _kzz_solve(Lz, Kzv).T.reshape(vs.shape[0], vs.shape[1], -1)


def lgssm_components_dtc(kernel, x, dtype, device):
    """(As, offs, Qs, (Cs, cs, Hs, hs), x0) of a DTCSeparable, or a Scaled or
    Sum of them by recursion: a Scaled scales the projection to the
    observations (H, h), a Sum is the direct sum of its children's states,
    their fan-outs side by side and their offsets summed."""
    N = grids.n_time(x)
    if isinstance(kernel, K.Scaled):
        As, offs, Qs, (Cs, cs, Hs, hs), x0 = lgssm_components_dtc(kernel.kernel, x, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(kernel.sigma2, dtype=dtype, device=device))
        return As, offs, Qs, (Cs, cs, _combine_leaves(lambda H: sigma * H, [Hs], N),
                              _combine_leaves(lambda h: sigma * h, [hs], N)), x0
    if isinstance(kernel, K.Sum):
        parts = [lgssm_components_dtc(c, x, dtype, device) for c in kernel.kernels]
        leaf = lambda i, j=None: [p[i] if j is None else p[i][j] for p in parts]
        cat = lambda *vs: torch.cat(vs, dim=-1)
        block = lambda *ms: psd.block_diag(list(ms))
        x0 = Gaussian(torch.cat([p[4].mean for p in parts], dim=-1),
                      psd.block_diag([p[4].cov for p in parts]))
        return (_combine_leaves(block, leaf(0), N), _combine_leaves(cat, leaf(1), N),
                _combine_leaves(block, leaf(2), N),
                (_combine_leaves(cat, leaf(3, 0), N), _combine_leaves(lambda *v: sum(v), leaf(3, 1), N),
                 _combine_leaves(block, leaf(3, 2), N), _combine_leaves(cat, leaf(3, 3), N)), x0)
    if not isinstance(kernel, DTCSeparable):
        raise TypeError(type(kernel))

    sep = kernel.k
    As_t, offs_t, Qs_t, (Hs_t, hs_t), x0_t = lgssm_components(sep.r, grids.get_times(x),
                                                               dtype, device)
    z = torch.as_tensor(kernel.z, device=device)
    M = z.shape[0]
    ident = torch.eye(M, dtype=dtype, device=device)
    As = _combine_leaves(lambda A: _kron(ident, A), [As_t], N)
    offs = _combine_leaves(lambda a: torch.tile(a, (M,)), [offs_t], N)
    Hs = _combine_leaves(lambda H: _kron(ident, H[..., None, :]), [Hs_t], N)
    hs = Fill(torch.zeros(M, dtype=dtype, device=device), N)
    Kzz_x0 = _chol_z(sep.l, z, dtype, 0.0)[0]
    x0 = Gaussian(torch.tile(x0_t.mean, (M,)), psd.symmetrize(_kron(Kzz_x0, x0_t.cov)))
    # K_zz's jitter: the reference's 1e-12 on a grid, 1e-9 on a RegularInTime.
    if isinstance(x, grids.RectilinearGrid):
        Kzz, Lz = _chol_z(sep.l, z, dtype, 1e-12)
        n_out = x.xl.shape[0]
        Cs = Fill(_fan_out(sep, z, Lz, x, dtype), N)
    elif isinstance(x, grids.RegularInTime):
        Kzz, Lz = _chol_z(sep.l, z, dtype, 1e-9)
        n_out = x.max_n
        Cs = _fan_out(sep, z, Lz, x, dtype)
    else:
        raise TypeError(type(x))
    Qs = _combine_leaves(lambda Q: _kron(Kzz, Q), [Qs_t], N)
    cs = _combine_leaves(lambda h: h[..., None].expand(*h.shape, n_out), [hs_t], N)
    return As, offs, Qs, (Cs, cs, Hs, hs), x0


def build_dtc_lgssm(kernel, x, noise_tf, mean_fn, dtype, device) -> LGSSM:
    """The pseudo-point LGSSM with BottleneckEmissions; the noise leaf the
    (Nt, Ns) or Fill((Ns,)) per-observation variances. ZeroMean only."""
    if not isinstance(mean_fn, ZeroMean):
        raise NotImplementedError("pseudo-point inference assumes a zero mean")
    from .builder import _temporal_det

    As, offs, Qs, (Cs, cs, Hs, hs), x0 = lgssm_components_dtc(kernel, x, dtype, device)
    return LGSSM(GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x0, forward=True,
                             det_blocks=_temporal_det(kernel)),
                 BottleneckEmissions(H=Hs, h=hs, C=Cs, c=cs, s_diag=noise_tf))


def _as(v, dtype):
    return v.to(dtype) if torch.is_tensor(v) else v


def kernel_diagonals(kernel, x, dtype, device):
    """(Nt, Ns) per-time diagonal of the exact kernel, for the ELBO's
    correction."""
    if isinstance(kernel, K.Scaled):
        return _as(kernel.sigma2, dtype) * kernel_diagonals(kernel.kernel, x, dtype, device)
    if isinstance(kernel, K.Sum):
        return sum(kernel_diagonals(c, x, dtype, device) for c in kernel.kernels)
    if isinstance(kernel, DTCSeparable):
        return gram_diag_grid(kernel.k, x, device).to(dtype)
    raise TypeError(type(kernel))


# ---------------------------------------------------------------------------
# dtc and elbo
# ---------------------------------------------------------------------------

def dtc(fx, y, z_r, *, engine=None):
    """The DTC objective: the lml of the pseudo-point model of fx at z_r (y
    flat, NaN missing)."""
    return gp_logpdf(dtcify(z_r, fx), y, engine=engine)


def _refuse_nan(y_tf, what):
    if bool(torch.isnan(y_tf).any()):
        raise ValueError(f"{what} requires fully-observed data (no NaNs); use "
                         "engine='block'/'sequential' for missing observations")


def elbo(fx, y, z_r, *, engine=None, n_warmup=None, nan_fallback=True):
    """Titsias' ELBO in state-space form: the DTC lml minus half the sum,
    over the observed entries, of (k(x, x) - q(x)) / noise, q the pseudo-
    point model's prior marginal variance without its noise. engine="lti"
    and "steady" take no missing data: a NaN in y raises ValueError (the
    reference's concrete-y branch; `nan_fallback` is its jit branch's and
    never acts here). `n_warmup` goes to the steady engine's lml."""
    fx_dtc = dtcify(z_r, fx)
    model = build_lgssm(fx_dtc)
    dtype = model.dtype
    y_tf = grids.observations_to_time_form(
        fx.x, torch.as_tensor(y, dtype=dtype, device=model.device))
    mask = torch.isnan(y_tf)
    Sigma = tmaterialize(model.emis.s_diag)
    marg_v = lgssm_mod.marginals_diag(model, engine=engine)[1]  # includes Sigma
    Cf_diag = kernel_diagonals(fx_dtc.f.f.kernel, fx_dtc.x, dtype, model.device)
    # sum over observed entries of (Cf - q) / Sigma: marg_v includes Sigma.
    tmp = ((Cf_diag - marg_v) / torch.where(mask, missings_mod.LARGE_VAR, Sigma)).sum(-1) \
        + (~mask).sum(-1)
    if engine in ("lti", "steady"):
        _refuse_nan(y_tf, f"elbo(engine={engine!r})")
        lp = lgssm_mod.logpdf(model, y_tf, engine=engine, n_warmup=n_warmup)
    else:
        lp = missings_mod.logpdf_with_missings(model, y_tf, engine=engine)
    return lp - 0.5 * tmp.sum()


# ---------------------------------------------------------------------------
# Approximate posterior marginals at new spatial points
# ---------------------------------------------------------------------------

def build_emission_covs(kernel: DTCSeparable, x_new, dtype, device):
    """The Nystrom residual of the spatial kernel at the new points times
    the temporal variance: (Nt, Ns) or (Nt, max_n)."""
    sep = kernel.k
    z = torch.as_tensor(kernel.z, device=device)
    Lz = _chol_z(sep.l, z, dtype, 1e-9)[1]
    time_vars = K.gram_diag(sep.r, time_array(grids.get_times(x_new), device)).to(dtype)
    if isinstance(x_new, grids.RectilinearGrid):
        pts = torch.as_tensor(x_new.xl, device=device)
        shape = (pts.shape[0],)
    elif isinstance(x_new, grids.RegularInTime):
        vs = torch.as_tensor(x_new.vs_padded, device=device)
        pts, shape = vs.flatten(0, 1), vs.shape[:2]
    else:
        raise TypeError(type(x_new))
    Kzv = K.gram(sep.l, z, pts).to(dtype)
    spatial_q = K.gram_diag(sep.l, pts).to(dtype) - (Kzv * _kzz_solve(Lz, Kzv)).sum(0)
    return time_vars[:, None] * spatial_q.reshape(shape)


def dtc_post_emissions(kernel, x_new, dtype, device):
    """((Cs, cs, Hs, hs), Sigma) of the prediction emissions at x_new:
    the projection of `lgssm_components_dtc` and the Nystrom noise."""
    N = grids.n_time(x_new)
    if isinstance(kernel, K.Scaled):
        (Cs, cs, Hs, hs), Sig = dtc_post_emissions(kernel.kernel, x_new, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(kernel.sigma2, dtype=dtype, device=device))
        return (Cs, cs, _combine_leaves(lambda H: sigma * H, [Hs], N),
                _combine_leaves(lambda h: sigma * h, [hs], N)), _as(kernel.sigma2, dtype) * Sig
    if isinstance(kernel, K.Sum):
        parts = [dtc_post_emissions(c, x_new, dtype, device) for c in kernel.kernels]
        leaf = lambda j: [p[0][j] for p in parts]
        cat = lambda *vs: torch.cat(vs, dim=-1)
        return ((_combine_leaves(cat, leaf(0), N), _combine_leaves(lambda *v: sum(v), leaf(1), N),
                 _combine_leaves(lambda *ms: psd.block_diag(list(ms)), leaf(2), N),
                 _combine_leaves(cat, leaf(3), N)), sum(p[1] for p in parts))
    if isinstance(kernel, DTCSeparable):
        return (lgssm_components_dtc(kernel, x_new, dtype, device)[3],
                build_emission_covs(kernel, x_new, dtype, device))
    raise TypeError(type(kernel))


def approx_posterior_marginals(fx, y, z_r, x_r, *, engine=None, n_warmup=None):
    """The pseudo-point posterior's (means, variances) at new spatial points
    at every training time, flat: x_r a RectilinearGrid or RegularInTime
    over fx's times, or the points themselves (a grid at fx's times).
    engine="steady" runs its smoother with the prediction emissions
    (ops/steady.posterior_marginals_diag), fully observed data only."""
    fx_dtc = dtcify(z_r, fx)
    model = build_lgssm(fx_dtc)
    dtype, device = model.dtype, model.device
    y_tf = grids.observations_to_time_form(fx.x, torch.as_tensor(y, dtype=dtype, device=device))
    if isinstance(x_r, (grids.RectilinearGrid, grids.RegularInTime)):
        x_pr = x_r
    else:
        x_pr = grids.RectilinearGrid(torch.as_tensor(x_r, device=device), grids.get_times(fx.x))
    (Cs, cs, Hs, hs), Sig = dtc_post_emissions(dtcify(z_r, fx.f.f.kernel), x_pr, dtype, device)
    new_emis = BottleneckEmissions(H=Hs, h=hs, C=Cs, c=cs, s_diag=Sig)
    if engine == "steady":
        from ..ops import steady

        _refuse_nan(y_tf, "approx_posterior_marginals(engine='steady')")
        m, v = steady.posterior_marginals_diag(model, y_tf, emis=new_emis, n_warmup=n_warmup)
    else:
        post = missings_mod.posterior_with_missings(model, y_tf, engine=engine)
        m, v = lgssm_mod.marginals_diag(LGSSM(post.trans, new_emis), engine=engine)
    return grids.destructure(x_pr, m), grids.destructure(x_pr, v)


def approx_posterior_marginals_at(fx, y, z_r, x_r, t: int, *, engine=None):
    """The pseudo-point posterior's (means, variances) at spatial points x_r
    at the single time index t: every other step predicts at one dummy
    point."""
    ts = grids.get_times(fx.x)
    Nt = num_times(ts)
    if t < 0 or t >= Nt:
        raise ValueError(f"t = {t} must be in [0, {Nt})")
    x_r = torch.as_tensor(x_r).detach().cpu().numpy()
    vs = [x_r[:1]] * Nt
    vs[t] = x_r
    x_pr = grids.regular_in_time(time_array(ts).detach().cpu().numpy(), vs)
    m, v = approx_posterior_marginals(fx, y, z_r, x_pr, engine=engine)
    start, n = sum(x_pr.counts[:t]), x_pr.counts[t]
    return m[start:start + n], v[start:start + n]
