"""LGSSM — model container and its inference functions
(temporalgps_tpu/models/lgssm.py): logpdf, filter_, posterior, marginals,
marginals_diag, latent_marginals, rand.

Engines ported:
  * "sequential" — a Python loop over time of ops/lgc steps; the ground
    truth, for any model the compiler builds (Fill or per-step parameters)
    and for both orderings.
  * "block"      — the block-parallel schedules of ops/block.py on the
    hand-written kernels (CUDA) or their plain versions (CPU); models the
    kernels do not take (D > 3) run its plain matrix path on either.
  * "parallel"   — the associative scan over all N steps (ops/assoc.py),
    batched tensor ops on either device.
  * "sqrt"       — the same scan in the square-root algebra (ops/sqrt.py):
    logpdf, filter_ and posterior; the data-free functions (marginals,
    latent_marginals, rand) run the sequential engine for it, as in the
    reference.
  * "lti"        — the time-invariant pipeline of a Fill forward model
    (ops/lti.py): logpdf, posterior, marginals, latent_marginals, rand;
    exact. Opt-in.
  * "steady"     — the steady-state engine of the same models
    (ops/steady.py): logpdf, marginals, latent_marginals, rand (exact); its
    covariances converged after `n_warmup` steps. Opt-in.

Emissions are any container of models/emissions.py: scalar observations
(a time series) or vector ones (a space-time grid's Ns observations a step,
DenseEmissions), whose step functions every engine shares.

The RTS smoother is, as in the reference, another LGSSM: reverse-ordered,
with inverted dynamics, whose x0 is the last filtering state. Step order per
ordering:
  forward: transition-predict, then emit / update;
  reverse: emit / update first, then transition.
"""

import dataclasses
import itertools
import warnings
from typing import Any

import torch

from ..config import POSTERIOR_JITTER
from ..ops import lgc
from ..utils import psd
from ..utils.fill import Fill, is_fill, tmaterialize
from ..utils.gaussian import Gaussian, gaussian_rand
from . import emissions as em
from .gauss_markov import GaussMarkov


@dataclasses.dataclass(frozen=True, eq=False)
class LGSSM:
    trans: GaussMarkov
    emis: Any  # a container of models/emissions.py

    def __len__(self):
        return len(self.trans)

    @property
    def latent_dim(self) -> int:
        return self.trans.dim

    @property
    def dtype(self):
        return self.trans.x0.mean.dtype

    @property
    def device(self):
        return self.trans.x0.mean.device


_PER_STEP = (("trans", "As"), ("trans", "offs"), ("trans", "Qs"),
             ("emis", "H"), ("emis", "h"), ("emis", "s"))


def model_leaves(model):
    """The tensors of a model: the per-step leaves (A, a, Q, H, h, s), a
    Fill by its value, then the prior's (m0, P0)."""
    per_step = [getattr(getattr(model, part), name) for part, name in _PER_STEP]
    x0 = model.trans.x0
    return (*(leaf.value if is_fill(leaf) else leaf for leaf in per_step), x0.mean, x0.cov)


def model_like(model, leaves):
    """A model of `model`'s structure (Fill where it has a Fill) over other
    leaf tensors, e.g. their derivatives along one parameter."""
    new = {"trans": {"x0": Gaussian(*leaves[6:])}, "emis": {}}
    for (part, name), leaf in zip(_PER_STEP, leaves):
        old = getattr(getattr(model, part), name)
        new[part][name] = Fill(leaf, old.N) if is_fill(old) else leaf
    return LGSSM(dataclasses.replace(model.trans, **new["trans"]),
                 dataclasses.replace(model.emis, **new["emis"]))


def _resolve_engine(engine, model=None):
    """`None` picks, for a model on a CUDA device, "block" for scalar
    emissions (the kernels for D <= 3, constant or per-step transitions; the
    matrix path beyond) and "parallel" for vector emissions (the space-time
    models, which no kernel takes), and "sequential" everywhere else (the
    reference picks "block" on the TPU up to D = 32, "sequential" above).
    The vector rule is the card's: c4's model (chip_smoke.py phase 18,
    "NVIDIA H100 80GB HBM3, 700.00 W") at D = 150 (50 x 1000) and D = 30
    (10 x 1000), ms float32 / float64:

        D = 150  logpdf               parallel 66 / 78,   block 81 / 92,
                                      sequential 1006 / 1057
                 posterior marginals  parallel 89 / 72,   block 95 / 105,
                                      sequential 2533 / 2567
        D = 30   logpdf               parallel 27 / 27,   block 44 / 70,
                                      sequential 893 / 941
                 posterior marginals  parallel 32 / 38,   block 56 / 70,
                                      sequential 2219 / 2536

    "parallel" wins at both sizes, so one rule, no latent_dim threshold.
    Either ordering: the reverse-ordered posterior's data-free functions
    (marginals, rand) run the affine prefix, and its `logpdf` the filter of
    its iteration view, where the reference's filtering functions fall back
    to their sequential scan, a Python loop of N steps in the port. Its own
    `posterior` is the exception: `posterior` passes no model for a
    reverse-ordered one, so `None` picks "sequential" there. "lti" and
    "steady" stay opt-in (the reference takes "lti" for data-free marginals
    only on its TPU)."""
    if engine is not None:
        return engine
    if model is not None and model.device.type == "cuda":
        return "block" if isinstance(model.emis, em.ScalarEmissions) else "parallel"
    return "sequential"


def _check_engine(engine, model=None):
    """Raise for an engine the port does not have, or, for "lti" and
    "steady", a model they do not take. "kron" is no engine of an LGSSM: it
    factors a grid's Separable model before any LGSSM is built
    (space_time/kron.py), so it is refused here rather than run on another
    engine."""
    if engine in ("block", "sequential", "parallel", "sqrt"):
        return
    if engine in ("lti", "steady"):
        from ..ops import lti

        if model is not None and not lti.supported(model):
            raise ValueError(f"engine={engine!r} requires a forward model with all-Fill "
                             "(time-invariant) transition and emission parameters")
        return
    if engine == "kron":
        raise ValueError(
            "engine='kron' runs on a grid's fx, not on an LGSSM: call gp.logpdf, gp.marginals, "
            "gp.rand or gp.posterior.marginals on to_sde(GP(Separable(...)))(grid, noise) with "
            "engine='kron'")
    raise ValueError(f"unknown engine {engine!r}")


def _obs(model, y):
    return torch.as_tensor(y, dtype=model.dtype, device=model.device)


# ---------------------------------------------------------------------------
# logpdf / filter / posterior
# ---------------------------------------------------------------------------

def logpdf(model: LGSSM, y, *, engine=None, fused=None, n_blocks=None, phase2=None,
           n_warmup=None):
    """Log marginal likelihood via the Kalman filter, either ordering. For
    engine="block", `fused=False` runs the plain PyTorch blocked schedule
    instead of the kernels, `n_blocks` overrides the block count and
    `phase2="sqrt"` takes the square-root prefix across the blocks (in
    tensor ops, in place of K2). `n_warmup` is the steady engine's exactly
    filtered head (ops/steady.suggest_warmup chooses one at small
    lambda dt). A float32 model on "lti" warns, as the reference does: its
    reverse-mode gradients through the power chain drift with N."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine, model)
    y = _obs(model, y)
    if engine == "lti":
        from ..ops import lti

        if model.dtype == torch.float32:
            warnings.warn(
                "logpdf(engine='lti') at float32: reverse-mode hyperparameter gradients "
                "through the lti power chain are numerically untrustworthy (the reference "
                "measured 22% relative error at N=4096). Use engine='steady'/'block', "
                "forward mode (learning.value_and_grad_fwd), or float64.",
                UserWarning, stacklevel=2)
        return lti.logpdf(model, y, n_blocks=n_blocks)
    if engine == "steady":
        from ..ops import steady

        return steady.logpdf(model, y, n_warmup=n_warmup, n_blocks=n_blocks)
    if engine == "block":
        from ..ops import block

        return block.logpdf(model, y, n_blocks=n_blocks, fused=fused, phase2=phase2)
    if engine in ("parallel", "sqrt"):
        return _engine_module(engine).logpdf(model, y)
    return _logpdf_sequential(model, y)


def _engine_module(engine):
    """ops/assoc.py for "parallel", ops/sqrt.py for "sqrt"."""
    from ..ops import assoc, sqrt

    return assoc if engine == "parallel" else sqrt


def filter_(model: LGSSM, y, *, engine=None, n_blocks=None) -> Gaussian:
    """Filtering distributions at every step, a stacked Gaussian
    ((N, D) means, (N, D, D) covariances)."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine)
    if engine in ("lti", "steady"):
        raise ValueError(f"filter_ has no engine {engine!r} (the reference's neither)")
    y = _obs(model, y)
    if engine == "block":
        from ..ops import block

        return block.filter_(model, y, n_blocks=n_blocks)
    if engine in ("parallel", "sqrt"):
        return _engine_module(engine).filter_(model, y)
    forward = model.trans.forward
    xs = []
    x = model.trans.x0
    for A, a, Q, e, yt in _iteration(model, y):
        if forward:
            x, _ = _update(lgc.predict(x, A, a, Q), e, yt)
            xs.append(x)
        else:
            xf, _ = _update(x, e, yt)
            xs.append(xf)
            x = lgc.predict(xf, A, a, Q)
    return _stack_gaussians(xs, forward)


def _invert_dynamics(first: Gaussian, second: Gaussian, A, jitter=POSTERIOR_JITTER):
    """Reversed conditioned dynamics (A_rev, a_rev, Q_rev), batched over
    leading axes:
        Gt = second.P^{-1} A first.P,
        A_rev = Gt^T, a_rev = first.m - Gt^T second.m,
        Q_rev = first.P - Gt^T second.P Gt,
    second.P carrying `jitter` on its diagonal."""
    Pf = psd.symmetrize(first.cov)
    Pp = psd.add_jitter(psd.symmetrize(second.cov), jitter)
    Gt = psd.chol_solve(psd.cholesky(Pp), A @ Pf)
    GtT = Gt.transpose(-1, -2)
    a_rev = first.mean - torch.einsum("...ij,...j->...i", GtT, second.mean)
    Q_rev = Pf - GtT @ Pp @ Gt
    return GtT, a_rev, Q_rev


def posterior(model: LGSSM, y, *, engine=None, n_blocks=None) -> LGSSM:
    """The smoother as an LGSSM of the opposite ordering: filter, emitting
    the inverted dynamics of every step; its x0 is the last filtering
    distribution and its emissions are the model's. `None` picks
    "sequential" for a reverse-ordered model on any device (engine="block"
    takes the associative engine for one). "lti" inverts every step's
    dynamics at once from its filter (ops/lti.py); "steady" has no posterior
    LGSSM (its smoother gives marginals: ops/steady.posterior_marginals_diag)."""
    engine = _resolve_engine(engine, model if model.trans.forward else None)
    _check_engine(engine, model)
    y = _obs(model, y)
    if engine == "lti":
        from ..ops import lti

        return lti.posterior(model, y, n_blocks=n_blocks)
    if engine == "steady":
        raise ValueError("posterior has no engine 'steady' (the reference's neither); "
                         "ops.steady.posterior_marginals_diag gives its smoothed marginals")
    if engine == "block":
        from ..ops import block

        return block.posterior(model, y, n_blocks=n_blocks)
    if engine in ("parallel", "sqrt"):
        return _engine_module(engine).posterior(model, y)
    forward = model.trans.forward
    dyn = []
    x = model.trans.x0
    # Each step's prediction and its inversion in float64, whatever the
    # model's dtype (as the block engine's reversal): Q_rev is a difference
    # of nearly equal covariances, which float32 cannot form.
    wide = lambda *ts: [t.to(torch.float64) for t in ts]
    narrow = lambda g: Gaussian(g.mean.to(model.dtype), g.cov.to(model.dtype))
    for A, a, Q, e, yt in _iteration(model, y):
        A64, a64, Q64 = wide(A, a, Q)
        if forward:
            x64 = Gaussian(*wide(x.mean, x.cov))
            xp64 = lgc.predict(x64, A64, a64, Q64)
            dyn.append(_invert_dynamics(x64, xp64, A64))
            x, _ = _update(narrow(xp64), e, yt)
        else:
            xf, _ = _update(x, e, yt)
            xf64 = Gaussian(*wide(xf.mean, xf.cov))
            x64 = lgc.predict(xf64, A64, a64, Q64)
            dyn.append(_invert_dynamics(x64, xf64, A64))
            x = narrow(x64)
    As, offs, Qs = (_stack([d[i] for d in dyn], forward).to(model.dtype) for i in range(3))
    trans = GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x, forward=not forward)
    return LGSSM(trans, model.emis)


# ---------------------------------------------------------------------------
# marginals
# ---------------------------------------------------------------------------

def marginals(model: LGSSM, *, engine=None, n_blocks=None) -> Gaussian:
    """Observation-space marginal at every step: for scalar emissions a
    Gaussian of (N,) means and (N,) variances, for vector emissions of
    (N, Dout) means and (N, Dout, Dout) covariances."""
    if isinstance(model.emis, em.ScalarEmissions):
        return Gaussian(*marginals_diag(model, engine=engine, n_blocks=n_blocks))
    return em.step_predict(latent_marginals(model, engine=engine, n_blocks=n_blocks),
                           em.map_leaves(tmaterialize, model.emis))


def marginals_diag(model: LGSSM, *, engine=None, n_blocks=None, n_warmup=None):
    """Observation-space marginal (means, variances), each (N,) for scalar
    emissions, (N, Dout) for vector ones."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine, model)
    if engine == "lti":
        from ..ops import lti

        return lti.marginals_diag(model)
    if engine == "steady":
        from ..ops import steady

        return steady.marginals_diag(model, n_warmup=n_warmup)
    if engine == "block":
        from ..ops import block

        return block.marginals_diag(model, n_blocks=n_blocks)
    if engine == "parallel":
        from ..ops import assoc

        return assoc.marginals_diag(model)
    out = [em.step_predict_marginals(x, e) for x, e in _latent_sequential(model)]
    return _stack([m for m, _ in out], model.trans.forward), _stack(
        [v for _, v in out], model.trans.forward)


def latent_marginals(model: LGSSM, *, engine=None, n_blocks=None, n_warmup=None) -> Gaussian:
    """Marginals of the latent chain itself, a stacked Gaussian."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine, model)
    if engine == "lti":
        from ..ops import lti

        return lti.latent_marginals(model, n_blocks=n_blocks)
    if engine == "steady":
        from ..ops import steady

        return steady.latent_marginals(model, n_warmup=n_warmup)
    if engine == "block":
        from ..ops import block

        return block.latent_marginals(model, n_blocks=n_blocks)
    if engine == "parallel":
        from ..ops import assoc

        return assoc.latent_marginals(model)
    return _stack_gaussians([x for x, _ in _latent_sequential(model)], model.trans.forward)


def _latent_sequential(model):
    """(latent marginal, emissions) of every step in iteration order."""
    x = model.trans.x0
    out = []
    for A, a, Q, e in _iteration(model):
        if model.trans.forward:
            x = lgc.predict(x, A, a, Q)
            out.append((x, e))
        else:
            out.append((x, e))
            x = lgc.predict(x, A, a, Q)
    return out


# ---------------------------------------------------------------------------
# The sequential engine's loop
# ---------------------------------------------------------------------------

def _steps(leaf, N):
    """Per-step values of a parameter leaf."""
    return itertools.repeat(leaf.value, N) if is_fill(leaf) else leaf.unbind(0)


def _iteration(model, *streams):
    """(A, a, Q, emissions, *stream values) of every step in iteration
    order: t = 0 .. N-1 for a forward model, N-1 .. 0 for a reverse one."""
    t, e = model.trans, model.emis
    N = len(model)
    emis = map(type(e), *(_steps(leaf, N) for leaf in em.leaves(e)))
    per_step = list(zip(
        _steps(t.As, N), _steps(t.offs, N), _steps(t.Qs, N), emis,
        *(s.unbind(0) for s in streams),
    ))
    return per_step if t.forward else per_step[::-1]


def _update(x, e, yt):
    return em.step_posterior_and_lml(x, e, yt)


def _stack(values, forward):
    """Stack per-step values collected in iteration order by time."""
    return torch.stack(values if forward else values[::-1])


def _stack_gaussians(xs, forward):
    return Gaussian(_stack([x.mean for x in xs], forward), _stack([x.cov for x in xs], forward))


def _logpdf_sequential(model: LGSSM, y):
    """Forward: predict, then update; reverse: update (emit), then
    transition."""
    forward = model.trans.forward
    x = model.trans.x0
    lmls = []
    for A, a, Q, e, yt in _iteration(model, y):
        if forward:
            x, lml = _update(lgc.predict(x, A, a, Q), e, yt)
        else:
            xf, lml = _update(x, e, yt)
            x = lgc.predict(xf, A, a, Q)
        lmls.append(lml)
    return torch.stack(lmls).sum()


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def rand(generator, model: LGSSM, *, engine=None):
    """A joint sample of the observations. All normals are drawn up front
    from `generator` (a torch.Generator on the model's device), in the
    reference's order: the initial state, then eps_t (N, D) for the
    transitions, then eps_e ((N,) scalar, (N, Dout) vector) for the
    emissions; `rand_with_eps` runs the chain on them."""
    N, D = len(model), model.latent_dim
    x_init = gaussian_rand(generator, model.trans.x0)
    normal = lambda *shape: torch.randn(shape, generator=generator, dtype=model.dtype,
                                        device=model.device)
    eps_t = normal(N, D)
    e = model.emis
    eps_e = normal(N) if isinstance(e, em.ScalarEmissions) else normal(N, em.dim_out(e))
    return rand_with_eps(model, eps_t, eps_e, x_init, engine=engine)


def rand_with_eps(model: LGSSM, eps_t, eps_e, x_init, *, engine=None, n_blocks=None):
    """The joint sample the standard normals eps_t (N, D), eps_e ((N,) or
    (N, Dout)) and the initial state x_init give, each indexed by time. engine="block" runs
    the affine block schedule (ops/block.rand_with_eps: K8-K10 for D <= 3);
    "sequential" the reference's steps: forward, transition then emit;
    reverse, emit then transition (eps_t of step 0 unused); "lti" and
    "steady" (Fill forward models) the constant-matrix affine recursion
    of ops/steady.rand_with_eps, exact."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine, model)
    if engine in ("lti", "steady"):
        from ..ops import steady

        return steady.rand_with_eps(model, eps_t, eps_e, x_init)
    if engine == "block":
        from ..ops import block

        return block.rand_with_eps(model, eps_t, eps_e, x_init, n_blocks=n_blocks)
    if engine == "parallel":
        from ..ops import assoc

        return assoc.rand_with_eps(model, eps_t, eps_e, x_init)
    forward = model.trans.forward
    x = x_init
    ys = []
    for A, a, Q, e, et, ee in _iteration(model, eps_t, eps_e):
        if forward:
            x = lgc.conditional_rand(et, x, A, a, Q)
            ys.append(em.step_conditional_rand(ee, x, e))
        else:
            ys.append(em.step_conditional_rand(ee, x, e))
            x = lgc.conditional_rand(et, x, A, a, Q)
    return _stack(ys, forward)
