"""Block-parallel Kalman schedules on the fused phase kernels
(temporalgps_tpu/ops/block.py, the Pallas paths `_logpdf_pallas_impl`,
`_posterior_pallas` and `marginals_diag_pallas`).

Time is cut into B blocks of L steps, stored as (L, B) streams of y and of
the noise s:

  phase 1 (K1)  each block folds its L step elements into one aggregate;
  phase 2 (K2)  a prefix over the B aggregates, seeded with the prior, gives
                the exact filtering state at every block start;
  phase 3 (K3)  each block runs the Kalman recursion from its start state and
                sums its log marginal likelihood.

The series is padded to B*L with steps that observe nothing (s = LARGE_VAR,
y = 0), whose lml is the closed-form constant the compensation removes. The
kernels take time-invariant (Fill) transition and emission parameters,
scalar observations with streamed noise, and D <= 3: the Matern models on
RegularSpacing. Other models raise NotImplementedError here and run on
engine="sequential".

Smoothing and prediction reuse phases 1 and 2 with a third phase that keeps
the filtering state after every step (K7 phase3_states): `filter_`, and
`posterior`, which inverts the dynamics step by step into a reverse-ordered
LGSSM in plain tensor ops. Marginals of a chain (the posterior's, or the
prior's) are a prefix composition of affine-Gaussian maps on the same
three-phase schedule (K8 affine_phase1, K9 affine_phase2_starts, K10
affine_phase3_states); that schedule takes per-step parameters and both
orderings, with D <= 3.

The reverse-mode gradient is a torch.autograd.Function whose backward re-runs
the plain PyTorch blocked schedule under autograd (the reference's custom_vjp
backward runs its XLA schedule the same way). The forward-mode gradient,
`logpdf_fwd_grad`, carries k tangent models beside the primal through the
same three phases on K4-K6 (kernels.phase1_jvp, phase2_jvp_starts,
phase3_jvp_lml): the path a hyperparameter fit takes.
"""

import math
from typing import Callable, NamedTuple

import torch

from ..config import LARGE_VAR, POSTERIOR_JITTER
from ..models.emissions import ScalarEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..models.missings import fill_in_missings, volume_compensation
from ..utils.fill import is_fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from . import kernels, lanes


class _Phases(NamedTuple):
    phase1_aggregate: Callable
    phase2_starts: Callable
    phase3_lml: Callable


KERNEL_PHASES = _Phases(kernels.phase1_aggregate, kernels.phase2_starts, kernels.phase3_lml)
PLAIN_PHASES = _Phases(
    kernels.phase1_aggregate_plain, kernels.phase2_starts_plain, kernels.phase3_lml_plain
)


class _StatePhases(NamedTuple):
    phase1_aggregate: Callable
    phase2_starts: Callable
    phase3_states: Callable


KERNEL_STATE_PHASES = _StatePhases(
    kernels.phase1_aggregate, kernels.phase2_starts, kernels.phase3_states)
PLAIN_STATE_PHASES = _StatePhases(
    kernels.phase1_aggregate_plain, kernels.phase2_starts_plain, kernels.phase3_states_plain)


class _AffinePhases(NamedTuple):
    affine_phase1: Callable
    affine_phase2_starts: Callable
    affine_phase3_states: Callable


KERNEL_AFFINE_PHASES = _AffinePhases(
    kernels.affine_phase1, kernels.affine_phase2_starts, kernels.affine_phase3_states)
PLAIN_AFFINE_PHASES = _AffinePhases(
    kernels.affine_phase1_plain, kernels.affine_phase2_starts_plain,
    kernels.affine_phase3_states_plain)

# Block count cap of the reference's fused phase-2 kernel (a TPU VMEM bound).
# K2 here takes any B; the cap is kept so both packages cut time the same way.
_PHASE2_FUSED_MAX_B = 2048


def _supports(model) -> bool:
    return model.trans.forward


def _pallas_supported(model) -> bool:
    """The models the fused kernels take (same scope as the reference's)."""
    t, e = model.trans, model.emis
    return (
        _supports(model)
        and isinstance(e, ScalarEmissions)
        and model.latent_dim <= 3
        and all(is_fill(leaf) for leaf in (t.As, t.offs, t.Qs, e.H, e.h))
    )


def _check_fused_model(model):
    """Raise NotImplementedError for a model the filtering kernels do not
    take."""
    if not _supports(model):
        raise NotImplementedError(
            "reverse-ordered models need the associative engine "
            "(ROADMAP Queue 1 item 10)"
        )
    if not _pallas_supported(model):
        raise NotImplementedError(
            "the port's block engine takes Fill-parameter scalar-emission models "
            "with D <= 3; the general block schedule (_logpdf_xla: per-step "
            "parameters such as irregular times, D > 3) is ROADMAP Queue 1 "
            "item 4b. Use engine='sequential'."
        )


def _use_kernels(model, fused) -> bool:
    """`fused=None` means the kernels for a model on a CUDA device and the
    plain versions for one on the CPU."""
    return model.device.type == "cuda" if fused is None else fused


def _pallas_blocks(N: int) -> int:
    """Block count: within-block length ~32, a power of two, at most
    _PHASE2_FUSED_MAX_B."""
    target = max(N // 32, min(N, 256))
    b = 1
    while b * 2 <= min(target, _PHASE2_FUSED_MAX_B):
        b *= 2
    return max(b, 1)


def _pad_tail(y, s, B, L):
    """Pad the y and s streams to B*L steps that observe nothing.

    A pad step has noise LARGE_VAR and y = 0; its lml is the constant
    -log(2 pi LARGE_VAR)/2 (up to O(H P H^T / LARGE_VAR) ~ 1e-15 relative),
    returned as the compensation to add back. The time-invariant parameters
    need no padding. Returns (y_padded, s_padded, compensation)."""
    n_pad = B * L - y.shape[0]
    if n_pad == 0:
        return y, s, 0.0
    comp = n_pad * 0.5 * math.log(2.0 * math.pi * LARGE_VAR)
    y_p = torch.cat([y, y.new_zeros(n_pad)])
    s_p = torch.cat([s, s.new_full((n_pad,), LARGE_VAR)])
    return y_p, s_p, comp


def _blocked_streams(y, s, B):
    """(y_main, s_main, compensation): the padded (L, B) streams of the
    kernels, L = ceil(N / B), block b holding steps b*L .. b*L + L - 1."""
    L = -(-y.shape[0] // B)
    y_p, s_p, comp = _pad_tail(y, s, B, L)
    return y_p.reshape(B, L).T.contiguous(), s_p.reshape(B, L).T.contiguous(), comp


def _logpdf_fused_impl(A, a, Q, H, h, s, y, m0, P0, B, phases: _Phases):
    """lml of the padded blocked schedule through the given phase functions."""
    D = m0.shape[-1]
    y_main, s_main, comp = _blocked_streams(y, s, B)
    packed = kernels.pack_params(A, a, Q, H, h, m0.dtype)
    comps = phases.phase1_aggregate(y_main, s_main, packed, D)
    starts = phases.phase2_starts(comps, m0, symmetrize(P0), D)
    return torch.sum(phases.phase3_lml(y_main, s_main, packed, starts, D)) + comp


class _LogpdfFused(torch.autograd.Function):
    """Forward through the kernel wrappers; backward through the plain
    blocked schedule (same function, PyTorch autograd)."""

    @staticmethod
    def forward(ctx, B, A, a, Q, H, h, s, y, m0, P0):
        ctx.B = B
        ctx.save_for_backward(A, a, Q, H, h, s, y, m0, P0)
        return _logpdf_fused_impl(A, a, Q, H, h, s, y, m0, P0, B, KERNEL_PHASES)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = _logpdf_fused_impl(*leaves, ctx.B, PLAIN_PHASES)
            wrt = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
        return (None, *(next(grads) if n else None for n in needs))


def _fused_leaves(model, y):
    t, e = model.trans, model.emis
    s = tmaterialize(e.s)
    return (t.As.value, t.offs.value, t.Qs.value, e.H.value, e.h.value, s, y,
            t.x0.mean, t.x0.cov)


def logpdf(model, y, *, n_blocks=None, fused=None):
    """Block-parallel logpdf. `fused=None` runs the kernels when the model's
    tensors are on a CUDA device (the reference's `pallas=None` picks Pallas
    on the TPU); `fused=False` runs the plain PyTorch blocked schedule."""
    _check_fused_model(model)
    fused = _use_kernels(model, fused)
    N = len(model)
    B = min(n_blocks or _pallas_blocks(N), N)
    leaves = _fused_leaves(model, y)
    if fused:
        return _LogpdfFused.apply(B, *leaves)
    return _logpdf_fused_impl(*leaves, B, PLAIN_PHASES)


def _fwd_grad_supported(model, model_tangents) -> bool:
    """The models `logpdf_fwd_grad` takes: a primal the fused kernels take,
    and tangents of Fill leaves, the noise tangent included."""
    if not _pallas_supported(model):
        return False
    for t in model_tangents:
        tr, e = t.trans, t.emis
        if not (
            isinstance(e, ScalarEmissions)
            and all(is_fill(leaf) for leaf in (tr.As, tr.offs, tr.Qs, e.H, e.h, e.s))
        ):
            return False
    return True


def _tangent_rows(model, model_tangents):
    """((1+k, PK2) parameter rows, (1+k, SD) prior rows) of K4-K6: the primal
    first, then each tangent. The primal noise slot is unused (the noise is
    streamed, with its fills); the tangent slots carry the time-invariant
    noise tangent."""
    dtype = model.dtype

    def row(m, s_slot):
        t, e = m.trans, m.emis
        return kernels.pack_params_s(t.As.value, t.offs.value, t.Qs.value, e.H.value,
                                     e.h.value, s_slot, dtype)

    def prior_row(x0):
        return torch.cat([x0.mean.reshape(-1), symmetrize(x0.cov).reshape(-1)]).to(dtype)

    rows = torch.stack([row(model, model.trans.x0.mean.new_zeros(()))]
                       + [row(t, t.emis.s.value) for t in model_tangents])
    priors = torch.stack([prior_row(model.trans.x0)]
                         + [prior_row(t.trans.x0) for t in model_tangents])
    return rows, priors


def logpdf_fwd_grad(model, y, model_tangents, *, n_blocks=None):
    """(logpdf, (k,) tensor of d logpdf . tangent_j) in one forward-mode pass.

    `model_tangents` is a list of k tangent LGSSMs: the derivative of every
    leaf of `model` along one parameter direction, as Fills (learning.
    value_and_grad_fwd_lgssm builds them with torch.func.jacfwd of
    `model_fn`). The primal and the k tangent recursions run together through
    K4-K6. y carries no tangent, and NaNs in it are missing observations,
    filled here; the time-invariant noise tangent enters masked, so missing
    and padding steps, whose lml is the constant the compensation adds back,
    contribute no derivative.

    Raises TypeError for models it does not take (`_fwd_grad_supported`)."""
    if not _fwd_grad_supported(model, model_tangents):
        raise TypeError(
            "logpdf_fwd_grad requires Fill-parameter scalar-emission models "
            "(primal and tangents) with D <= 3"
        )
    k = len(model_tangents)
    if k < 1:
        raise ValueError("logpdf_fwd_grad needs at least one tangent model")
    D = model.latent_dim
    dtype = model.dtype
    N = len(model)
    # The reference shrinks B by 1+k here, a VMEM bound of its phase-2 kernel
    # that K5 does not have: value and gradient cut time the same way.
    B = min(n_blocks or _pallas_blocks(N), N)
    y = torch.as_tensor(y, dtype=dtype, device=model.device)
    s, y_f, n_missing = fill_in_missings(tmaterialize(model.emis.s), y)
    y_main, s_main, comp = _blocked_streams(y_f, s, B)
    comp = comp + volume_compensation(n_missing, dtype)

    rows, priors = _tangent_rows(model, model_tangents)
    comps = kernels.phase1_jvp(y_main, s_main, rows, D, k)
    starts = kernels.phase2_jvp_starts(comps, priors, D, k)
    totals = kernels.phase3_jvp_lml(y_main, s_main, rows, starts, D, k).sum(dim=1)
    return totals[0] + comp, totals[1:]


# ---------------------------------------------------------------------------
# Smoothing and prediction: filtering states (K1, K2, K7), the posterior's
# reversed dynamics, and marginals on the affine prefix (K8, K9, K10)
# ---------------------------------------------------------------------------

def _unblock_states(st, N):
    """(SD, L, B) states -> (SD, N) in time order, the padding dropped."""
    SD, L, B = st.shape
    return st.transpose(1, 2).reshape(SD, B * L)[:, :N]


def _comps_to_gaussian(comps, D):
    """(SD, N) state rows -> a stacked Gaussian ((N, D), (N, D, D))."""
    N = comps.shape[1]
    return Gaussian(comps[:D].T, comps[D:].T.reshape(N, D, D))


def _filter_state_comps(model, y, n_blocks, fused):
    """(SD, N) filtering states of every step, on K1 -> K2 -> K7."""
    _check_fused_model(model)
    phases = KERNEL_STATE_PHASES if _use_kernels(model, fused) else PLAIN_STATE_PHASES
    t, e = model.trans, model.emis
    D, N = model.latent_dim, len(model)
    B = min(n_blocks or _pallas_blocks(N), N)
    y_main, s_main, _ = _blocked_streams(y, tmaterialize(e.s), B)
    packed = kernels.pack_params(t.As.value, t.offs.value, t.Qs.value, e.H.value, e.h.value,
                                 model.dtype)
    comps = phases.phase1_aggregate(y_main, s_main, packed, D)
    starts = phases.phase2_starts(comps, t.x0.mean, symmetrize(t.x0.cov), D)
    return _unblock_states(phases.phase3_states(y_main, s_main, packed, starts, D), N)


def filter_(model, y, *, n_blocks=None, fused=None) -> Gaussian:
    """Filtering distributions at every step on the blocked schedule; the
    padding steps observe nothing, so the real steps' states are exact."""
    return _comps_to_gaussian(_filter_state_comps(model, y, n_blocks, fused), model.latent_dim)


def _mat_to_array(M):
    """Component matrix of (N,) tensors -> (N, D, D)."""
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def posterior(model, y, *, n_blocks=None, fused=None):
    """The smoother as a reverse-ordered LGSSM (models.lgssm.posterior) on
    the blocked schedule: the filtering states from K1, K2, K7, then the
    dynamics of every step inverted in plain tensor ops on (N,) component
    vectors, with the adjugate inverse of ops/lanes.py and POSTERIOR_JITTER
    (the reference's `_posterior_pallas`)."""
    return _reversed_model(model, _filter_state_comps(model, y, n_blocks, fused))


def _reversed_model(model, xf):
    """The reverse-ordered posterior LGSSM from the (SD, N) filtering states."""
    D = model.latent_dim
    t, x0 = model.trans, model.trans.x0
    mf, Pf = kernels._state_rows_to_tuple(xf.unbind(0), D)

    def prev(comp, init):  # the state before each step: x0, then the filtering states
        return torch.cat([init.reshape(1), comp[:-1]])

    x0P = symmetrize(x0.cov)
    m_prev = tuple(prev(mf[i], x0.mean[i]) for i in range(D))
    P_prev = tuple(tuple(prev(Pf[r][c], x0P[r, c]) for c in range(D)) for r in range(D))
    A, a, Q = t.As.value, t.offs.value, t.Qs.value
    A_c = tuple(tuple(A[r, c] for c in range(D)) for r in range(D))
    Q_c = tuple(tuple(Q[r, c] for c in range(D)) for r in range(D))
    mp = lanes.vadd(lanes.mv(A_c, m_prev), tuple(a.unbind(0)))
    Pp = lanes.madd(lanes.sym(lanes.mmT(lanes.mm(A_c, P_prev), A_c)), Q_c)
    Ppj = tuple(tuple(Pp[r][c] + (POSTERIOR_JITTER if r == c else 0.0) for c in range(D))
                for r in range(D))
    G = lanes.mm(lanes.inv(Ppj), lanes.mm(A_c, P_prev))
    A_rev = tuple(tuple(G[c][r] for c in range(D)) for r in range(D))
    a_rev = lanes.vsub(m_prev, lanes.mTv(G, mp))
    Q_rev = lanes.msub(P_prev, lanes.mTm(G, lanes.mm(Ppj, G)))

    x_last = Gaussian(xf[:D, -1], xf[D:, -1].reshape(D, D))
    trans = GaussMarkov(As=_mat_to_array(A_rev), offs=torch.stack(a_rev, dim=-1),
                        Qs=_mat_to_array(Q_rev), x0=x_last, forward=False)
    return LGSSM(trans, model.emis)


def _marginals_supported(model) -> bool:
    """The models the affine kernels take: D <= 3 (any ordering, Fill or
    per-step parameters)."""
    return model.latent_dim <= 3


def _affine_comps_iteration(model, B):
    """The model's transitions in iteration order as the affine kernels'
    (KT, L, B) rows, L = ceil(N / B), padded with identity maps.

    A forward model transitions, then emits, so state t includes transition
    t. A reverse model emits, then transitions: flipped to iteration order
    and shifted by one with the identity map first (its x0 is already the
    state at the last step), dropping the transition out of step 0."""
    t = model.trans
    D, N = model.latent_dim, len(model)
    dtype, device = model.dtype, model.device
    F, c, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    rows = torch.cat([F.reshape(N, D * D), c.reshape(N, D), Q.reshape(N, D * D)], dim=1)
    ident = torch.cat([torch.eye(D, dtype=dtype, device=device).reshape(-1),
                       torch.zeros(D + D * D, dtype=dtype, device=device)])
    if not t.forward:
        rows = torch.cat([ident[None], rows.flip(0)[:-1]])
    L = -(-N // B)
    rows = torch.cat([rows, ident.expand(B * L - N, -1)])
    return rows.reshape(B, L, -1).permute(2, 1, 0).contiguous()


def latent_marginal_comps(model, *, n_blocks=None, fused=None):
    """(SD, N) latent marginals in time order on K8 -> K9 -> K10."""
    if not _marginals_supported(model):
        raise NotImplementedError(
            "the port's affine block schedule takes D <= 3; larger states are "
            "ROADMAP Queue 1 item 4b. Use engine='sequential'."
        )
    N = len(model)
    B = min(n_blocks or _pallas_blocks(N), N)
    return _affine_states(model, _affine_comps_iteration(model, B), fused)


def _affine_states(model, params, fused):
    """(SD, N) states in time order from the model's (KT, L, B) iteration
    rows, on K8 -> K9 -> K10."""
    phases = KERNEL_AFFINE_PHASES if _use_kernels(model, fused) else PLAIN_AFFINE_PHASES
    D, x0 = model.latent_dim, model.trans.x0
    agg = phases.affine_phase1(params, D)
    starts = phases.affine_phase2_starts(agg, x0.mean, symmetrize(x0.cov), D)
    comps = _unblock_states(phases.affine_phase3_states(params, starts, D), len(model))
    return comps if model.trans.forward else comps.flip(1)


def latent_marginals(model, *, n_blocks=None, fused=None) -> Gaussian:
    """Marginals of the latent chain on the affine block schedule."""
    comps = latent_marginal_comps(model, n_blocks=n_blocks, fused=fused)
    return _comps_to_gaussian(comps, model.latent_dim)


def marginals_diag(model, *, n_blocks=None, fused=None):
    """(means, variances) of the scalar observations, (H m + h, H P H^T + s)
    on the component rows of the latent marginals."""
    return _project(model, latent_marginal_comps(model, n_blocks=n_blocks, fused=fused))


def _project(model, comps):
    """(H m + h, H P H^T + s) of the (SD, N) latent state rows."""
    e = model.emis
    m, P = kernels._state_rows_to_tuple(comps.unbind(0), model.latent_dim)
    H = e.H.value if is_fill(e.H) else e.H.T
    H_c = tuple(H.unbind(0))
    h = e.h.value if is_fill(e.h) else e.h
    mu = lanes.vdot(H_c, m) + h
    var = lanes.vdot(H_c, lanes.mv(P, H_c)) + tmaterialize(e.s)
    return mu, var
