"""Block-parallel Kalman schedules (temporalgps_tpu/ops/block.py): the fused
phase kernels (the Pallas paths `_logpdf_pallas_impl`, `_posterior_pallas`
and `marginals_diag_pallas`) and the general block schedule (`_logpdf_xla`,
`filter_`, `posterior`, `affine_prefix_states`).

Time is cut into B blocks of L steps, stored as (L, B) streams of y and of
the noise s:

  phase 1 (K1)  each block folds its L step elements into one aggregate (and
                keeps the aggregates of the runs of steps it folds apart);
  phase 2 (K2)  a prefix over the B aggregates, seeded with the prior, gives
                the exact filtering state at every block start;
  phase 3 (K3)  each block runs the Kalman recursion from its start state and
                sums its log marginal likelihood (each run from the block
                start pushed through the earlier runs' aggregates).

The series is padded to B*L with steps that observe nothing (identity
transitions with zero noise, s = LARGE_VAR, y = 0), whose lml is the
closed-form constant the compensation removes.

Scalar-emission models take one of three routes:

  Fill (A, a, Q, H, h), D <= 3   K1-K3 on the constant packed parameters;
  per-step (A, a, Q), D <= 3     K1 and K3 reading each step's (A, a, Q) from
                                 a (KT, L, B) row stream (the streamed forms,
                                 kernels.*_streamed), K2 unchanged; on the CPU
                                 the lane path, their plain versions run
                                 serially (the reference's
                                 `_phase1_aggregates_lanes`,
                                 `_phase3_lml_lanes`);
  D > 3, or per-step H           the matrix path: the same three phases in
                                 batched (B, D, D) tensor ops, on the card
                                 too (the reference's XLA schedule has no
                                 Pallas kernel either), on the element
                                 algebra of ops/assoc.py (whose inverse
                                 carries no jitter, unlike the reference's).

Vector emissions (DenseEmissions, LargeEmissions: the space-time models)
take the matrix path at any D, their (N, Dout, ...) leaves padded and
blocked like the rest.

`phase2="sqrt"` runs phase 2 in the square-root algebra of ops/sqrt.py
(batched tensor ops over the B block aggregates; K2 is the covariance form),
between K1 and K3 on the card or their plain versions on the CPU.

A per-step emission offset h (a CustomMean) moves into the observations,
y - h_t, before the streams are cut (`_kernel_emission`): the innovation
y - H m - h is the same function, and the kernels read one h. A
reverse-ordered model (the smoother's posterior) is filtered as the
forward-ordered model of its iteration view (`_forward_view`): flipped y and
emissions, and the shifted transitions as per-step rows, so its `logpdf`
runs the streamed K1, K2, the streamed K3 (the reference falls back to its
associative engine there). The kernels run for a model on a CUDA device, at
`_pallas_blocks` blocks; the plain schedules at `_default_blocks`.

Smoothing and prediction reuse phases 1 and 2 with a third phase that keeps
the filtering state after every step (K7 phase3_states, streamed or not;
the matrix phase 3 for D > 3): `filter_`, and `posterior`, which inverts the
dynamics step by step into a reverse-ordered LGSSM (plain tensor ops on
(N,) components for D <= 3, batched Cholesky solves for D > 3); a
reverse-ordered model's posterior is the associative engine's, as in the
reference. Marginals
of a chain (the posterior's, or the prior's) are a prefix composition of
affine-Gaussian maps on the same three-phase schedule (K8 affine_phase1, K9
affine_phase2_starts, K10 affine_phase3_states, D <= 3, both orderings;
the matrix `affine_prefix_states` for D > 3). A joint sample is the same
prefix on the maps (F, c + chol(Q) eps_t) with zero covariance rows
(`rand_with_eps`).

The reverse-mode gradient is a torch.autograd.Function whose backward re-runs
the plain PyTorch blocked schedule under autograd (the reference's custom_vjp
backward runs its XLA schedule the same way). The forward-mode gradient,
`logpdf_fwd_grad`, carries k tangent models beside the primal through the
same three phases on K4-K6 (kernels.phase1_jvp, phase2_jvp_starts,
phase3_jvp_lml): the path a hyperparameter fit takes for Fill models. The
reference's `jax.checkpoint` of the matrix phases at D > 8 is a memory
device of reverse mode and is not carried over.
"""

import math
from typing import Callable, NamedTuple

import torch

from ..config import LARGE_VAR, POSTERIOR_JITTER
from ..models import emissions as em
from ..models.emissions import ScalarEmissions
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM
from ..models.missings import fill_in_missings, volume_compensation
from ..utils.fill import is_fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize
from . import assoc, kernels, lanes, sqrt
from .assoc import (_associative_scan, _combine_affine, _combine_filter, _iteration_view, _mT,
                    _mv, _prior_element, _reversed_model_matrix, _sample_maps, posterior_filter_model,
                    step_elements)



class _Phases(NamedTuple):
    phase1_aggregate: Callable
    phase2_starts: Callable
    phase3_lml: Callable


KERNEL_PHASES = _Phases(kernels.phase1_aggregate, kernels.phase2_starts, kernels.phase3_lml)
STREAMED_PHASES = _Phases(
    kernels.phase1_aggregate_streamed, kernels.phase2_starts, kernels.phase3_lml_streamed)
# The plain versions take the constant packed parameters, or per-step rows
# through trans_rows=: they stand in for both kernel forms.
PLAIN_PHASES = _Phases(
    kernels.phase1_aggregate_plain, kernels.phase2_starts_plain, kernels.phase3_lml_plain
)


class _StatePhases(NamedTuple):
    phase1_aggregate: Callable
    phase2_starts: Callable
    phase3_states: Callable


KERNEL_STATE_PHASES = _StatePhases(
    kernels.phase1_aggregate, kernels.phase2_starts, kernels.phase3_states)
STREAMED_STATE_PHASES = _StatePhases(
    kernels.phase1_aggregate_streamed, kernels.phase2_starts, kernels.phase3_states_streamed)
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


def _pallas_supported(model) -> bool:
    """The models the constant-parameter kernels take (the reference's
    Pallas scope): forward-ordered, Fill transitions, scalar emissions with a
    Fill H, D <= 3 (a per-step h moves into y)."""
    t = model.trans
    return (
        t.forward
        and _streamed_supported(model)
        and all(is_fill(leaf) for leaf in (t.As, t.offs, t.Qs))
    )


def _streamed_supported(model) -> bool:
    """The models the filtering kernels take in one of their two forms, once
    in forward order (`_forward_view`): scalar emissions with a Fill H,
    D <= 3; (A, a, Q) Fill or per step; h Fill or per step (it moves into
    y, `_kernel_emission`)."""
    e = model.emis
    return isinstance(e, ScalarEmissions) and model.latent_dim <= 3 and is_fill(e.H)


def _use_kernels(model, fused) -> bool:
    """`fused=None` means the kernels for a model on a CUDA device and the
    plain versions for one on the CPU."""
    return model.device.type == "cuda" if fused is None else fused


def _pallas_blocks(N: int) -> int:
    """Block count of the kernels: within-block length ~32, a power of two,
    at most _PHASE2_FUSED_MAX_B."""
    target = max(N // 32, min(N, 256))
    b = 1
    while b * 2 <= min(target, _PHASE2_FUSED_MAX_B):
        b *= 2
    return max(b, 1)


def _default_blocks(N: int) -> int:
    """Block count of the plain general schedule (the reference's
    `_default_blocks`): ~8 sqrt(N), a power of two, at most 8192. The
    reference caps it at 32 for D > 16 (fewer, fatter blocks measured faster
    on its TPU, and a shallower combine tree finite there in float32); on the
    card the space-time model c4 (D = 150, N = 1000) ran the block engine's
    logpdf 1.9x faster at 128 blocks than at 32 and its float32 posterior
    means came 1.54e-3 from the float32 problem solved in float64 against
    1.92e-3 (probes/torch_c4_blocks.py), so the port does not cap it."""
    b = 1
    target = int(8 * (N ** 0.5))
    while b * 2 <= min(target, 8192):
        b *= 2
    return max(b, 1)


def _blocks(model, n_blocks, kernel_cut: bool) -> int:
    """B: `n_blocks` if given, else the kernels' cut or the plain general
    schedule's; at most N."""
    N = len(model)
    return min(n_blocks or (_pallas_blocks(N) if kernel_cut else _default_blocks(N)), N)


def _pad_tail(y, s, B, L):
    """Pad the y and s streams to B*L steps that observe nothing.

    A pad step has noise LARGE_VAR and y = 0; its lml is the constant
    -log(2 pi LARGE_VAR)/2 (up to O(H P H^T / LARGE_VAR) ~ 1e-15 relative),
    returned as the compensation to add back. Transitions are padded apart:
    constants need nothing, per-step rows take identity steps
    (`_rows_blocked`). Returns (y_padded, s_padded, compensation)."""
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


def _rows_blocked(F, c, Q, B):
    """(N, D, D), (N, D), (N, D, D) transitions -> the (KT, L, B) rows of
    the streamed and affine kernels, L = ceil(N / B), rows A, a, Q, padded
    with identity steps (A = I, a = 0, Q = 0)."""
    N, D = F.shape[0], F.shape[-1]
    rows = torch.cat([F.reshape(N, D * D), c.reshape(N, D), Q.reshape(N, D * D)], dim=1)
    ident = torch.cat([torch.eye(D, dtype=F.dtype, device=F.device).reshape(-1),
                       F.new_zeros(D + D * D)])
    L = -(-N // B)
    rows = torch.cat([rows, ident.expand(B * L - N, -1)])
    return rows.reshape(B, L, -1).permute(2, 1, 0).contiguous()


def _emission_params(H, h, dtype):
    """The (PK,) packed row of the streamed kernels: H and h; the transition
    slots, which they do not read, zero."""
    D = H.shape[-1]
    return kernels.pack_params(H.new_zeros(D, D), H.new_zeros(D), H.new_zeros(D, D), H, h, dtype)


def _logpdf_fused_impl(A, a, Q, H, h, s, y, m0, P0, B, phases: _Phases):
    """lml of the padded blocked schedule through the given phase functions.
    A, a, Q are the constant (D, D), (D,), (D, D) values, or per-step
    (N, ...) tensors, which go to the phases as (KT, L, B) rows."""
    D = m0.shape[-1]
    y_main, s_main, comp = _blocked_streams(y, s, B)
    if A.ndim == 3:
        rows = dict(trans_rows=_rows_blocked(A, a, Q, B))
        packed = _emission_params(H, h, m0.dtype)
    else:
        rows = {}
        packed = kernels.pack_params(A, a, Q, H, h, m0.dtype)
    comps, runs = phases.phase1_aggregate(y_main, s_main, packed, D, **rows)
    starts = phases.phase2_starts(comps, m0, symmetrize(P0), D)
    return torch.sum(phases.phase3_lml(y_main, s_main, packed, starts, D, runs, **rows)) + comp


class _LogpdfFused(torch.autograd.Function):
    """Forward through the kernel wrappers, K1 and K3 on constant parameters
    or their streamed forms on per-step (A, a, Q), K2 or the square-root
    phase 2 between them; backward through the plain blocked schedule (same
    function, PyTorch autograd): for per-step parameters the lane path."""

    @staticmethod
    def forward(ctx, B, phase2, A, a, Q, H, h, s, y, m0, P0):
        ctx.B, ctx.phase2 = B, phase2
        ctx.save_for_backward(A, a, Q, H, h, s, y, m0, P0)
        kernel, streamed, _ = LOGPDF_PHASES[phase2]
        return _logpdf_fused_impl(A, a, Q, H, h, s, y, m0, P0, B,
                                  streamed if A.ndim == 3 else kernel)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = _logpdf_fused_impl(*leaves, ctx.B, LOGPDF_PHASES[ctx.phase2][2])
            wrt = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def _forward_view(model, y=None):
    """(model, y) of a forward-ordered model as they are; a reverse-ordered
    model as the forward-ordered model of its iteration view, which filters
    the same steps in the same order: its transitions shifted by one
    (`_iteration_view`, per-step), its emissions and y flipped, the same x0.
    Step i of the view is step N-1-i of the model."""
    if model.trans.forward:
        return model, y
    F, c, Q = _iteration_view(model)
    flip = lambda leaf: leaf if is_fill(leaf) else leaf.flip(0)
    view = LGSSM(GaussMarkov(As=F, offs=c, Qs=Q, x0=model.trans.x0, forward=True,
                             det_blocks=model.trans.det_blocks),
                 em.map_leaves(flip, model.emis))
    return view, None if y is None else y.flip(0)


def _kernel_emission(model, y):
    """(H, h, y) as the filtering kernels read them: the Fill H and h, or,
    for a per-step h, h = 0 and the observations y - h_t (the same
    innovation y - H m - h; in float32 the subtraction rounds once)."""
    e = model.emis
    if is_fill(e.h):
        return e.H.value, e.h.value, y
    return e.H.value, e.h.new_zeros(()), y - e.h


def _fused_leaves(model, y):
    """(A, a, Q, H, h, s, y, m0, P0): the Fill values of a constant model,
    the (N, ...) transitions of a per-step one."""
    t, e = model.trans, model.emis
    s = tmaterialize(e.s)
    if _pallas_supported(model):
        A, a, Q = t.As.value, t.offs.value, t.Qs.value
    else:
        A, a, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    H, h, y = _kernel_emission(model, y)
    return (A, a, Q, H, h, s, y, t.x0.mean, t.x0.cov)


def logpdf(model, y, *, n_blocks=None, fused=None, phase2=None):
    """Block-parallel logpdf, either ordering (a reverse-ordered model
    through `_forward_view`). `fused=None` runs the kernels when the model's
    tensors are on a CUDA device (the reference's `pallas=None` picks Pallas
    on the TPU); `fused=False` runs the plain PyTorch blocked schedule: for
    Fill models K1-K3's plain versions, for per-step (A, a, Q) the lane path
    (the reference's `_logpdf_xla` with `pallas=False`). Models the kernels
    do not take (D > 3, per-step H) run the matrix path.

    `phase2="sqrt"` runs the prefix over the block aggregates in the
    square-root algebra (ops/sqrt.py) in tensor ops, in place of K2: on the
    card between K1 and K3 (streamed or not), with `fused=False` between
    their plain versions; the matrix path runs it in its phase 2."""
    if phase2 not in LOGPDF_PHASES:
        raise ValueError(f"unknown phase2 {phase2!r}")
    model, y = _forward_view(model, y)
    if not _streamed_supported(model):
        return _logpdf_matrix(model, y, _blocks(model, n_blocks, False), phase2)
    fused = _use_kernels(model, fused)
    B = _blocks(model, n_blocks, fused or _pallas_supported(model))
    leaves = _fused_leaves(model, y)
    if fused:
        return _LogpdfFused.apply(B, phase2, *leaves)
    return _logpdf_fused_impl(*leaves, B, LOGPDF_PHASES[phase2][2])


def _fwd_grad_supported(model, model_tangents) -> bool:
    """The models `logpdf_fwd_grad` takes: a primal the constant-parameter
    kernels take with a Fill h, and tangents of Fill leaves, the noise
    tangent included."""
    if not (_pallas_supported(model) and is_fill(model.emis.h)):
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
    comps, chunk_comps = kernels.phase1_jvp(y_main, s_main, rows, D, k)
    starts = kernels.phase2_jvp_starts(comps, priors, D, k)
    totals = kernels.phase3_jvp_lml(y_main, s_main, rows, starts, D, k, chunk_comps).sum(dim=1)
    return totals[0] + comp, totals[1:]


# ---------------------------------------------------------------------------
# The matrix path (the reference's general block schedule for D > 3):
# elements, states and transitions as batched (B, ...) tensors
# ---------------------------------------------------------------------------

def _blocked_leaves(model, y, B):
    """((A, a, Q, emissions, y), each leaf an (L, B, ...) tensor,
    compensation): the reference's `_pad_tail` and `_split_tree`. A Fill
    leaf pads with its own value, a per-step one with an identity
    transition, zero offset, process noise and emission; the observation
    noise always pads with LARGE_VAR (LARGE_VAR I for a dense covariance),
    and y with 0, each pad step taking the constant compensation of its
    Dout observations."""
    t, e = model.trans, model.emis
    N, D = len(model), model.latent_dim
    L = -(-N // B)
    n_pad = B * L - N
    dtype, device = model.dtype, model.device

    def pad(leaf, pad_value=None):
        x = tmaterialize(leaf)
        value = leaf.value if pad_value is None else pad_value
        x = torch.cat([x, value.to(x).expand(n_pad, *value.shape)])
        return x.reshape(B, L, *x.shape[1:]).transpose(0, 1)

    def pad_emission(leaf):
        if is_fill(leaf):
            return pad(leaf)
        return pad(leaf, leaf.new_zeros(leaf.shape[1:]))

    noise = tmaterialize(em.noise_cov(e))
    large = torch.full(noise.shape[1:], LARGE_VAR, dtype=dtype, device=device)
    if isinstance(e, em.DenseEmissions):
        large = torch.diag_embed(large.diagonal())
    emis = em.replace_noise_cov(em.map_leaves(pad_emission, e), pad(noise, large))
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    per_step = lambda leaf, value: pad(leaf, None if is_fill(leaf) else value)
    leaves = (per_step(t.As, torch.eye(D, dtype=dtype, device=device)), per_step(t.offs, z(D)),
              per_step(t.Qs, z(D, D)), emis, pad(y, z(*y.shape[1:])))
    return leaves, n_pad * em.dim_out(e) * 0.5 * math.log(2.0 * math.pi * LARGE_VAR)


def _at(e, l):
    """Step l of a blocked emission container: each leaf's (B, ...) slice."""
    return em.map_leaves(lambda leaf: leaf[l], e)


def _phase2_prefix(elems, phase2=None):
    """Inclusive prefix of an element tuple with the prior element first (the
    reference's `_phase2_prefix`); phase2="sqrt" combines in the square-root
    algebra (ops/sqrt.py), whose covariances stay PSD by construction, and
    returns the covariance form."""
    if phase2 == "sqrt":
        sqrt.check_dim(elems[0].shape[-1])
        return sqrt.from_sqrt_element(
            _associative_scan(sqrt._combine_sqrt, sqrt.to_sqrt_element(elems)))
    return _associative_scan(_combine_filter, elems)


def _prefix_from(prior, aggs, scan):
    """Exclusive block starts (m, P), each (B, ...): the prefix (`scan` of
    an element tuple) of the prior element and the B aggregates, without its
    last entry."""
    pref = scan(tuple(torch.cat([p, a]) for p, a in zip(prior, aggs)))
    return pref[1][:-1], pref[2][:-1]


def _phase2_starts_sqrt(comps, x0_mean, x0_cov, D):
    """K2's function in the square-root algebra: (K, B) block aggregate rows
    -> (SD, B) block-start states."""
    B, DD = comps.shape[1], D * D
    rows = comps.T
    agg = (rows[:, :DD].reshape(B, D, D), rows[:, DD:DD + D],
           rows[:, DD + D:2 * DD + D].reshape(B, D, D), rows[:, 2 * DD + D:2 * DD + 2 * D],
           rows[:, 2 * DD + 2 * D:].reshape(B, D, D))
    m, P = _prefix_from(_prior_element(Gaussian(x0_mean, x0_cov), D, comps), agg,
                        lambda e: _phase2_prefix(e, "sqrt"))
    return _gaussian_to_comps(Gaussian(m, P))


# logpdf's phases by its phase2: (the kernels on constant parameters, their
# streamed forms, the plain versions).
LOGPDF_PHASES = {
    None: (KERNEL_PHASES, STREAMED_PHASES, PLAIN_PHASES),
    "sqrt": tuple(p._replace(phase2_starts=_phase2_starts_sqrt)
                  for p in (KERNEL_PHASES, STREAMED_PHASES, PLAIN_PHASES)),
}


def _matrix_starts(model, blocked, phase2=None):
    """Phases 1 and 2 of the matrix path: each block's fold of its step
    elements (from its first: the identity element in front of it would
    combine to the same tuple), then the prefix with the prior element
    (0, m0, P0, 0, 0) in front (`_phase2_prefix`); the (B, D), (B, D, D)
    block starts."""
    A, a, Q, e, y = blocked
    agg = step_elements(A[0], a[0], Q[0], _at(e, 0), y[0])
    for l in range(1, A.shape[0]):
        agg = _combine_filter(agg, step_elements(A[l], a[l], Q[l], _at(e, l), y[l]))
    return _prefix_from(_prior_element(model.trans.x0, model.latent_dim, agg[0]), agg,
                        lambda e: _phase2_prefix(e, phase2))


def _kalman_steps(x, blocked, l):
    """Predict and update of every block at step l, x a Gaussian of (B, ...)
    states (the reference's `lgc.predict` and `emissions.step_posterior_and_lml`)."""
    A, a, Q, e, y = blocked
    pred = Gaussian(_mv(A[l], x.mean) + a[l], A[l] @ symmetrize(x.cov) @ _mT(A[l]) + Q[l])
    return em.step_posterior_and_lml(pred, _at(e, l), y[l])


def _logpdf_matrix(model, y, B, phase2=None):
    """lml on the matrix path (the reference's `_logpdf_xla` for models the
    lane path does not take)."""
    blocked, comp = _blocked_leaves(model, y, B)
    x = Gaussian(*_matrix_starts(model, blocked, phase2))
    acc = x.mean.new_zeros(x.mean.shape[0])
    for l in range(blocked[0].shape[0]):
        x, lml = _kalman_steps(x, blocked, l)
        acc = acc + lml
    return acc.sum() + comp


def _filter_matrix(model, y, B) -> Gaussian:
    """Filtering states of every step on the matrix path (the reference's
    `block.filter_`), ((N, D), (N, D, D))."""
    blocked, _ = _blocked_leaves(model, y, B)
    x = Gaussian(*_matrix_starts(model, blocked))
    ms, Ps = [], []
    for l in range(blocked[0].shape[0]):
        x, _ = _kalman_steps(x, blocked, l)
        ms.append(x.mean)
        Ps.append(x.cov)
    N, D = len(model), model.latent_dim
    mean = torch.stack(ms, 1).reshape(-1, D)[:N]
    return Gaussian(mean, torch.stack(Ps, 1).reshape(-1, D, D)[:N])


# ---------------------------------------------------------------------------
# Smoothing and prediction: filtering states (K1, K2, K7, streamed or not;
# the matrix path for D > 3), the posterior's reversed dynamics, and
# marginals on the affine prefix (K8, K9, K10; the matrix path for D > 3)
# ---------------------------------------------------------------------------

def _unblock_states(st, N):
    """(SD, L, B) states -> (SD, N) in time order, the padding dropped."""
    SD, L, B = st.shape
    return st.transpose(1, 2).reshape(SD, B * L)[:, :N]


def _comps_to_gaussian(comps, D):
    """(SD, N) state rows -> a stacked Gaussian ((N, D), (N, D, D))."""
    N = comps.shape[1]
    return Gaussian(comps[:D].T, comps[D:].T.reshape(N, D, D))


def _gaussian_to_comps(x):
    """A stacked Gaussian ((N, D), (N, D, D)) -> (SD, N) state rows."""
    N = x.mean.shape[0]
    return torch.cat([x.mean.T, x.cov.reshape(N, -1).T])


def _filter_state_comps(model, y, n_blocks, fused):
    """(SD, N) filtering states of every step, on K1 -> K2 -> K7: the
    constant forms for a Fill model, the streamed forms for per-step
    (A, a, Q); on the CPU their plain versions (`fused=None`)."""
    use = _use_kernels(model, fused)
    t, e = model.trans, model.emis
    D, N = model.latent_dim, len(model)
    B = _blocks(model, n_blocks, use or _pallas_supported(model))
    H, h, y = _kernel_emission(model, y)
    y_main, s_main, _ = _blocked_streams(y, tmaterialize(e.s), B)
    if _pallas_supported(model):
        phases = KERNEL_STATE_PHASES if use else PLAIN_STATE_PHASES
        rows = {}
        packed = kernels.pack_params(t.As.value, t.offs.value, t.Qs.value, H, h, model.dtype)
    else:
        phases = STREAMED_STATE_PHASES if use else PLAIN_STATE_PHASES
        rows = dict(trans_rows=_rows_blocked(*_iteration_view(model), B))
        packed = _emission_params(H, h, model.dtype)
    comps, _ = phases.phase1_aggregate(y_main, s_main, packed, D, **rows)
    starts = phases.phase2_starts(comps, t.x0.mean, symmetrize(t.x0.cov), D)
    return _unblock_states(phases.phase3_states(y_main, s_main, packed, starts, D, **rows), N)


def filter_(model, y, *, n_blocks=None, fused=None) -> Gaussian:
    """Filtering distributions at every step on the blocked schedule; the
    padding steps observe nothing, so the real steps' states are exact. A
    reverse-ordered model's are those of its iteration view (`_forward_view`),
    flipped back to time order."""
    view, y = _forward_view(model, y)
    if not _streamed_supported(view):
        xf = _filter_matrix(view, y, _blocks(view, n_blocks, False))
    else:
        xf = _comps_to_gaussian(_filter_state_comps(view, y, n_blocks, fused), view.latent_dim)
    return xf if model.trans.forward else Gaussian(xf.mean.flip(0), xf.cov.flip(0))


def _mat_to_array(M):
    """Component matrix of (N,) tensors -> (N, D, D)."""
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def posterior(model, y, *, n_blocks=None, fused=None):
    """The smoother as a reverse-ordered LGSSM (models.lgssm.posterior) on
    the blocked schedule. For the models the filtering kernels take: the
    filtering states from K1, K2, K7, then the dynamics of every step
    inverted in plain tensor ops on (N,) component vectors, with the
    adjugate inverse of ops/lanes.py and POSTERIOR_JITTER (the reference's
    `_posterior_pallas`). Otherwise the matrix filter (in float64 for a
    float32 model, `assoc.posterior_filter_model`) and the batched Cholesky
    inversion of models.lgssm (the reference's `block.posterior`).
    A reverse-ordered model's posterior is the associative engine's
    (ops/assoc.py), as the reference's block engine hands it there."""
    if not model.trans.forward:
        return assoc.posterior(model, y)
    if not _streamed_supported(model):
        view, y_view = posterior_filter_model(model, y)
        return _reversed_model_matrix(
            model, _filter_matrix(view, y_view, _blocks(model, n_blocks, False)))[0]
    return _reversed_model(model, _filter_state_comps(model, y, n_blocks, fused))[0]


def _components(X, D):
    """Component matrix of a (D, D) value or an (N, D, D) per-step tensor."""
    return tuple(tuple(X[..., r, c] for c in range(D)) for r in range(D))


def _reversed_model(model, xf, jitter=POSTERIOR_JITTER):
    """(posterior, predictions): the reverse-ordered posterior LGSSM from the
    (SD, N) filtering states, the transitions constant (0-dim components) or
    per step ((N,) ones), and the predicted state of every step (float64,
    stacked) that it inverts the dynamics against, `jitter` on each
    predicted covariance (the Fisher gradient's exact smoother passes 0).
    Computed in float64 whatever the model's dtype, then stored in it: Q_rev
    is a difference of nearly equal covariances (at a merged step of dt = 0,
    of equal ones), which float32 cannot form."""
    D = model.latent_dim
    t, x0 = model.trans, model.trans.x0
    mf, Pf = kernels._state_rows_to_tuple(xf.double().unbind(0), D)

    def prev(comp, init):  # the state before each step: x0, then the filtering states
        return torch.cat([init.reshape(1), comp[:-1]])

    x0P = symmetrize(x0.cov).double()
    m_prev = tuple(prev(mf[i], x0.mean[i].double()) for i in range(D))
    P_prev = tuple(tuple(prev(Pf[r][c], x0P[r, c]) for c in range(D)) for r in range(D))
    value = lambda leaf: (leaf.value if is_fill(leaf) else leaf).double()
    A_c, Q_c = _components(value(t.As), D), _components(value(t.Qs), D)
    a_c = tuple(value(t.offs)[..., i] for i in range(D))
    mp = lanes.vadd(lanes.mv(A_c, m_prev), a_c)
    Pp = lanes.madd(lanes.sym(lanes.mmT(lanes.mm(A_c, P_prev), A_c)), Q_c)
    Ppj = tuple(tuple(Pp[r][c] + (jitter if r == c else 0.0) for c in range(D))
                for r in range(D))
    G = lanes.mm(lanes.inv(Ppj), lanes.mm(A_c, P_prev))
    A_rev = tuple(tuple(G[c][r] for c in range(D)) for r in range(D))
    a_rev = lanes.vsub(m_prev, lanes.mTv(G, mp))
    Q_rev = lanes.msub(P_prev, lanes.mTm(G, lanes.mm(Ppj, G)))

    x_last = Gaussian(xf[:D, -1], xf[D:, -1].reshape(D, D))
    narrow = lambda x: x.to(model.dtype)
    trans = GaussMarkov(As=narrow(_mat_to_array(A_rev)), offs=narrow(torch.stack(a_rev, dim=-1)),
                        Qs=narrow(_mat_to_array(Q_rev)), x0=x_last, forward=False,
                        det_blocks=model.trans.det_blocks)
    return LGSSM(trans, model.emis), Gaussian(torch.stack(mp, dim=-1), _mat_to_array(Pp))


def _marginals_supported(model) -> bool:
    """The models the affine kernels take: D <= 3 (any ordering, Fill or
    per-step parameters)."""
    return model.latent_dim <= 3


def _affine_comps_iteration(model, B):
    """The model's transitions in iteration order as the affine kernels'
    (KT, L, B) rows, L = ceil(N / B), padded with identity maps."""
    return _rows_blocked(*_iteration_view(model), B)


def _latent_marginals_matrix(model, n_blocks=None) -> Gaussian:
    """Latent marginals in time order on the matrix `affine_prefix_states`."""
    F, c, Q = _iteration_view(model)
    x0 = model.trans.x0
    x = affine_prefix_states(F, c, Q, x0.mean, x0.cov, n_blocks=n_blocks)
    return x if model.trans.forward else Gaussian(x.mean.flip(0), x.cov.flip(0))


def latent_marginal_comps(model, *, n_blocks=None, fused=None):
    """(SD, N) latent marginals in time order: on K8 -> K9 -> K10 for
    D <= 3, on the matrix `affine_prefix_states` otherwise."""
    if not _marginals_supported(model):
        return _gaussian_to_comps(_latent_marginals_matrix(model, n_blocks))
    B = _blocks(model, n_blocks, True)
    return _affine_states(model, _affine_comps_iteration(model, B), fused)


def affine_prefix_states(F, c, Q, x0_mean, x0_cov, *, n_blocks=None) -> Gaussian:
    """States x_t of x_t = F_t x_{t-1} + c_t + N(0, Q_t), t = 1..N, from
    x_0 ~ (x0_mean, x0_cov), on the matrix path of the reference's
    `affine_prefix_states` (its `use_lanes = False` side): each block's
    maps composed, the prefix of the block aggregates with x0 in front, and
    each block replayed from its start. Inputs (N, ...) in iteration order;
    returns ((N, D), (N, D, D))."""
    N, D = F.shape[0], F.shape[-1]
    B = min(n_blocks or _default_blocks(N), N)
    rows = _rows_blocked(F, c, Q, B)  # identity-padded (KT, L, B)
    L = rows.shape[1]
    Fb = rows[:D * D].permute(1, 2, 0).reshape(L, B, D, D)
    cb = rows[D * D:D * D + D].permute(1, 2, 0)
    Qb = rows[D * D + D:].permute(1, 2, 0).reshape(L, B, D, D)
    eye = torch.eye(D, dtype=F.dtype, device=F.device)
    agg = (eye.expand(B, D, D), F.new_zeros(B, D), F.new_zeros(B, D, D))
    for l in range(L):
        agg = _combine_affine(agg, (Fb[l], cb[l], Qb[l]))
    prior = (F.new_zeros(1, D, D), x0_mean[None].to(F), symmetrize(x0_cov)[None].to(F))
    m, P = _prefix_from(prior, agg, lambda e: _associative_scan(_combine_affine, e))
    ms, Ps = [], []
    for l in range(L):
        m = _mv(Fb[l], m) + cb[l]
        P = symmetrize(Fb[l] @ P @ _mT(Fb[l]) + Qb[l])
        ms.append(m)
        Ps.append(P)
    return Gaussian(torch.stack(ms, 1).reshape(-1, D)[:N],
                    torch.stack(Ps, 1).reshape(-1, D, D)[:N])


def _affine_state_rows(params, x0_mean, x0_cov, D, N, use_kernels):
    """(SD, N) states in iteration order from (KT, L, B) rows and the
    initial state, on K8 -> K9 -> K10 (their plain versions when
    `use_kernels` is false)."""
    phases = KERNEL_AFFINE_PHASES if use_kernels else PLAIN_AFFINE_PHASES
    agg, chunk_aggs = phases.affine_phase1(params, D)
    starts = phases.affine_phase2_starts(agg, x0_mean, x0_cov, D)
    return _unblock_states(phases.affine_phase3_states(params, starts, D, chunk_aggs), N)


def _affine_states(model, params, fused):
    """(SD, N) states in time order from the model's (KT, L, B) iteration
    rows, on K8 -> K9 -> K10."""
    x0 = model.trans.x0
    comps = _affine_state_rows(params, x0.mean, symmetrize(x0.cov), model.latent_dim,
                               len(model), _use_kernels(model, fused))
    return comps if model.trans.forward else comps.flip(1)


def _emissions_iteration(model):
    """The emissions in iteration order: a Fill leaf by its value, a
    per-step leaf flipped for a reverse-ordered model."""
    leaf = lambda x: x.value if is_fill(x) else (x if model.trans.forward else x.flip(0))
    return em.map_leaves(leaf, model.emis)


def rand_with_eps(model, eps_t, eps_e, x_init, *, n_blocks=None):
    """The joint sample of the observations that the standard normals eps_t
    (N, D), eps_e ((N,) or (N, Dout)) and the initial state x_init give (the
    reference's `block.rand_with_eps`): the iteration view's maps x -> F x + b
    with b = c + chol(Q + RAND_JITTER I) eps_t (for a reverse-ordered model
    eps_t flipped and shifted by one with a zero first, as its transitions
    are), composed from x_init, then each step's observation given its state
    (`emissions.step_conditional_rand`; y = H x + h + sqrt(s) eps_e for a
    scalar one). For D <= 3 the
    states are the mean rows of K8 -> K9 -> K10 on the (KT, L, B) rows of
    (F, b, 0) from (x_init, 0): the covariance rows stay exactly zero and
    are dropped. For D > 3 the matrix `affine_prefix_states`."""
    forward = model.trans.forward
    F, b = _sample_maps(model, eps_t)
    eps_e = eps_e if forward else eps_e.flip(0)
    N, D = len(model), model.latent_dim
    zero_cov = x_init.new_zeros(D, D)
    if _marginals_supported(model):
        B = _blocks(model, n_blocks, True)
        rows = _rows_blocked(F, b, torch.zeros_like(F), B)
        xs = _affine_state_rows(rows, x_init, zero_cov, D, N, _use_kernels(model, None))[:D].T
    else:
        xs = affine_prefix_states(F, b, torch.zeros_like(F), x_init, zero_cov,
                                  n_blocks=n_blocks).mean
    ys = em.step_conditional_rand(eps_e, xs, _emissions_iteration(model))
    return ys if forward else ys.flip(0)


def latent_marginals(model, *, n_blocks=None, fused=None) -> Gaussian:
    """Marginals of the latent chain on the affine block schedule."""
    if not _marginals_supported(model):
        return _latent_marginals_matrix(model, n_blocks)
    comps = latent_marginal_comps(model, n_blocks=n_blocks, fused=fused)
    return _comps_to_gaussian(comps, model.latent_dim)


def marginals_diag(model, *, n_blocks=None, fused=None):
    """(means, variances) of the observations. Scalar ones: (H m + h,
    H P H^T + s) on the component rows of the latent marginals; vector ones:
    `emissions.step_predict_marginals` of the latent marginals."""
    if not isinstance(model.emis, ScalarEmissions):
        return em.step_predict_marginals(latent_marginals(model, n_blocks=n_blocks, fused=fused),
                                         em.map_leaves(tmaterialize, model.emis))
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
