"""LGSSM — model container and its inference functions
(temporalgps_tpu/models/lgssm.py): logpdf, filter_, posterior, marginals,
marginals_diag, latent_marginals.

Engines ported:
  * "sequential" — a Python loop over time of ops/lgc steps; the ground
    truth, for any model the compiler builds (Fill or per-step parameters)
    and for both orderings.
  * "block"      — the block-parallel schedules of ops/block.py on the
    hand-written kernels (CUDA) or their plain versions (CPU); models the
    kernels do not take (D > 3) run its plain matrix path on either.

The RTS smoother is, as in the reference, another LGSSM: reverse-ordered,
with inverted dynamics, whose x0 is the last filtering state. Step order per
ordering:
  forward: transition-predict, then emit / update;
  reverse: emit / update first, then transition.
"""

import dataclasses
import itertools
from typing import Any

import torch

from ..config import POSTERIOR_JITTER
from ..ops import lgc
from ..utils import psd
from ..utils.fill import is_fill
from ..utils.gaussian import Gaussian
from . import emissions as em
from .gauss_markov import GaussMarkov


@dataclasses.dataclass(frozen=True, eq=False)
class LGSSM:
    trans: GaussMarkov
    emis: Any  # ScalarEmissions

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


def _resolve_engine(engine, model=None):
    """`None` picks "block" for any forward-ordered model on a CUDA device
    (the kernels for D <= 3, constant or per-step transitions; the matrix
    path beyond), and "sequential" everywhere else (the reference picks
    "block" on the TPU). The filtering functions (logpdf, filter_, posterior)
    use it."""
    if engine is not None:
        return engine
    if model is not None and model.device.type == "cuda" and model.trans.forward:
        return "block"
    return "sequential"


def _resolve_engine_affine(engine, model=None):
    """`_resolve_engine` for the data-free functions (marginals,
    marginals_diag, latent_marginals): their block schedule, the affine
    prefix (K8-K10 for D <= 3, the matrix path beyond), takes both
    orderings, so `None` picks "block" for any model on a CUDA device (the
    reverse-ordered posterior among them), "sequential" elsewhere."""
    if engine is not None:
        return engine
    if model is not None and model.device.type == "cuda":
        return "block"
    return "sequential"


_NOT_PORTED = {
    "parallel": "ROADMAP Queue 1 item 10",
    "sqrt": "ROADMAP Queue 1 item 10",
    "lti": "ROADMAP Queue 1 item 10",
    "steady": "ROADMAP Queue 1 item 8",
}


def _check_engine(engine):
    """Raise for an engine other than "block" and "sequential"."""
    if engine in ("block", "sequential"):
        return
    if engine in _NOT_PORTED:
        raise NotImplementedError(f"engine={engine!r} is not ported yet ({_NOT_PORTED[engine]})")
    raise ValueError(f"unknown engine {engine!r}")


def _obs(model, y):
    return torch.as_tensor(y, dtype=model.dtype, device=model.device)


# ---------------------------------------------------------------------------
# logpdf / filter / posterior
# ---------------------------------------------------------------------------

def logpdf(model: LGSSM, y, *, engine=None, fused=None, n_blocks=None):
    """Log marginal likelihood via the Kalman filter. For engine="block",
    `fused=False` runs the plain PyTorch blocked schedule instead of the
    kernels, and `n_blocks` overrides the block count."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine)
    y = _obs(model, y)
    if engine == "block":
        from ..ops import block

        return block.logpdf(model, y, n_blocks=n_blocks, fused=fused)
    return _logpdf_sequential(model, y)


def filter_(model: LGSSM, y, *, engine=None, n_blocks=None) -> Gaussian:
    """Filtering distributions at every step, a stacked Gaussian
    ((N, D) means, (N, D, D) covariances)."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine)
    y = _obs(model, y)
    if engine == "block":
        from ..ops import block

        return block.filter_(model, y, n_blocks=n_blocks)
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


def _invert_dynamics(first: Gaussian, second: Gaussian, A):
    """Reversed conditioned dynamics (A_rev, a_rev, Q_rev), batched over
    leading axes:
        Gt = second.P^{-1} A first.P,
        A_rev = Gt^T, a_rev = first.m - Gt^T second.m,
        Q_rev = first.P - Gt^T second.P Gt,
    second.P carrying POSTERIOR_JITTER on its diagonal."""
    Pf = psd.symmetrize(first.cov)
    Pp = psd.add_jitter(psd.symmetrize(second.cov), POSTERIOR_JITTER)
    Gt = psd.chol_solve(psd.cholesky(Pp), A @ Pf)
    GtT = Gt.transpose(-1, -2)
    a_rev = first.mean - torch.einsum("...ij,...j->...i", GtT, second.mean)
    Q_rev = Pf - GtT @ Pp @ Gt
    return GtT, a_rev, Q_rev


def posterior(model: LGSSM, y, *, engine=None, n_blocks=None) -> LGSSM:
    """The smoother as an LGSSM of the opposite ordering: filter, emitting
    the inverted dynamics of every step; its x0 is the last filtering
    distribution and its emissions are the model's."""
    engine = _resolve_engine(engine, model)
    _check_engine(engine)
    y = _obs(model, y)
    if engine == "block":
        from ..ops import block

        return block.posterior(model, y, n_blocks=n_blocks)
    forward = model.trans.forward
    dyn = []
    x = model.trans.x0
    for A, a, Q, e, yt in _iteration(model, y):
        if forward:
            xp = lgc.predict(x, A, a, Q)
            dyn.append(_invert_dynamics(x, xp, A))
            x, _ = _update(xp, e, yt)
        else:
            xf, _ = _update(x, e, yt)
            x = lgc.predict(xf, A, a, Q)
            dyn.append(_invert_dynamics(x, xf, A))
    As, offs, Qs = (_stack([d[i] for d in dyn], forward) for i in range(3))
    trans = GaussMarkov(As=As, offs=offs, Qs=Qs, x0=x, forward=not forward)
    return LGSSM(trans, model.emis)


# ---------------------------------------------------------------------------
# marginals
# ---------------------------------------------------------------------------

def marginals(model: LGSSM, *, engine=None, n_blocks=None) -> Gaussian:
    """Observation-space marginal at every step: for scalar emissions a
    Gaussian of (N,) means and (N,) variances."""
    return Gaussian(*marginals_diag(model, engine=engine, n_blocks=n_blocks))


def marginals_diag(model: LGSSM, *, engine=None, n_blocks=None):
    """Observation-space marginal (means, variances), each (N,)."""
    engine = _resolve_engine_affine(engine, model)
    _check_engine(engine)
    if engine == "block":
        from ..ops import block

        return block.marginals_diag(model, n_blocks=n_blocks)
    out = [em.step_predict_marginals(x, e) for x, e in _latent_sequential(model)]
    return _stack([m for m, _ in out], model.trans.forward), _stack(
        [v for _, v in out], model.trans.forward)


def latent_marginals(model: LGSSM, *, engine=None, n_blocks=None) -> Gaussian:
    """Marginals of the latent chain itself, a stacked Gaussian."""
    engine = _resolve_engine_affine(engine, model)
    _check_engine(engine)
    if engine == "block":
        from ..ops import block

        return block.latent_marginals(model, n_blocks=n_blocks)
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
    per_step = list(zip(
        _steps(t.As, N), _steps(t.offs, N), _steps(t.Qs, N),
        map(em.ScalarEmissions, _steps(e.H, N), _steps(e.h, N), _steps(e.s, N)),
        *(s.unbind(0) for s in streams),
    ))
    return per_step if t.forward else per_step[::-1]


def _update(x, e, yt):
    return lgc.posterior_and_lml_scalar(x, e.H, e.h, e.s, yt)


def _stack(values, forward):
    """Stack per-step values collected in iteration order by time."""
    return torch.stack(values if forward else values[::-1])


def _stack_gaussians(xs, forward):
    return Gaussian(_stack([x.mean for x in xs], forward), _stack([x.cov for x in xs], forward))


def _logpdf_sequential(model: LGSSM, y):
    if not model.trans.forward:
        raise NotImplementedError(
            "logpdf of a reverse-ordered model is not ported yet (ROADMAP Queue 1 item 6)"
        )
    x = model.trans.x0
    lmls = []
    for A, a, Q, e, yt in _iteration(model, y):
        x, lml = _update(lgc.predict(x, A, a, Q), e, yt)
        lmls.append(lml)
    return torch.stack(lmls).sum()
