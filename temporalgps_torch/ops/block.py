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

Forward-ordered scalar-emission models take one of three routes:

  Fill (A, a, Q, H, h), D <= 3   K1-K3 on the constant packed parameters;
  per-step (A, a, Q), D <= 3     K1 and K3 reading each step's (A, a, Q) from
                                 a (KT, L, B) row stream (the streamed forms,
                                 kernels.*_streamed), K2 unchanged; on the CPU
                                 the lane path, their plain versions run
                                 serially (the reference's
                                 `_phase1_aggregates_lanes`,
                                 `_phase3_lml_lanes`);
  D > 3, or per-step H or h      the matrix path: the same three phases in
                                 batched (B, D, D) tensor ops, on the card
                                 too (the reference's XLA schedule has no
                                 Pallas kernel either).

The kernels run for a model on a CUDA device, at `_pallas_blocks` blocks;
the plain schedules at `_default_blocks`. Reverse-ordered models raise (the
reference falls back to its associative engine, ROADMAP items 6 and 10).

Smoothing and prediction reuse phases 1 and 2 with a third phase that keeps
the filtering state after every step (K7 phase3_states, streamed or not;
the matrix phase 3 for D > 3): `filter_`, and `posterior`, which inverts the
dynamics step by step into a reverse-ordered LGSSM (plain tensor ops on
(N,) components for D <= 3, batched Cholesky solves for D > 3). Marginals
of a chain (the posterior's, or the prior's) are a prefix composition of
affine-Gaussian maps on the same three-phase schedule (K8 affine_phase1, K9
affine_phase2_starts, K10 affine_phase3_states, D <= 3, both orderings;
the matrix `affine_prefix_states` for D > 3).

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

_LOG2PI = math.log(2.0 * math.pi)

# Block count cap of the reference's fused phase-2 kernel (a TPU VMEM bound).
# K2 here takes any B; the cap is kept so both packages cut time the same way.
_PHASE2_FUSED_MAX_B = 2048


def _supports(model) -> bool:
    return model.trans.forward


def _pallas_supported(model) -> bool:
    """The models the constant-parameter kernels take (the reference's
    Pallas scope): Fill parameters, scalar emissions, D <= 3."""
    t = model.trans
    return (
        _streamed_supported(model)
        and all(is_fill(leaf) for leaf in (t.As, t.offs, t.Qs))
    )


def _streamed_supported(model) -> bool:
    """The models the filtering kernels take in one of their two forms:
    forward-ordered, scalar emissions with Fill H and h, D <= 3; (A, a, Q)
    Fill or per step."""
    e = model.emis
    return (
        _supports(model)
        and isinstance(e, ScalarEmissions)
        and model.latent_dim <= 3
        and is_fill(e.H) and is_fill(e.h)
    )


def _check_general_model(model):
    """Raise NotImplementedError for a model no block schedule of the port
    takes."""
    if not _supports(model):
        raise NotImplementedError(
            "reverse-ordered models need the associative engine "
            "(ROADMAP Queue 1 items 6 and 10)"
        )
    if not isinstance(model.emis, ScalarEmissions):
        raise NotImplementedError(
            "vector emissions (Dense, Large, Bottleneck) are not ported yet "
            "(ROADMAP Queue 1 item 7)"
        )


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


def _default_blocks(N: int, D: int = 1) -> int:
    """Block count of the plain general schedule (the reference's
    `_default_blocks`): ~8 sqrt(N), a power of two, at most 8192 (32 for
    D > 16, where fewer, fatter blocks keep the combine tree shallow)."""
    b = 1
    target = int(8 * (N ** 0.5))
    cap = 8192 if D <= 16 else 32
    while b * 2 <= min(target, cap):
        b *= 2
    return max(b, 1)


def _blocks(model, n_blocks, kernel_cut: bool) -> int:
    """B: `n_blocks` if given, else the kernels' cut or the plain general
    schedule's; at most N."""
    N = len(model)
    return min(n_blocks or (_pallas_blocks(N) if kernel_cut else
                            _default_blocks(N, model.latent_dim)), N)


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
    """Forward through the kernel wrappers, K1-K3 on constant parameters or
    their streamed forms on per-step (A, a, Q); backward through the plain
    blocked schedule (same function, PyTorch autograd): for per-step
    parameters the lane path."""

    @staticmethod
    def forward(ctx, B, A, a, Q, H, h, s, y, m0, P0):
        ctx.B = B
        ctx.save_for_backward(A, a, Q, H, h, s, y, m0, P0)
        phases = STREAMED_PHASES if A.ndim == 3 else KERNEL_PHASES
        return _logpdf_fused_impl(A, a, Q, H, h, s, y, m0, P0, B, phases)

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
    """(A, a, Q, H, h, s, y, m0, P0): the Fill values of a constant model,
    the (N, ...) transitions of a per-step one."""
    t, e = model.trans, model.emis
    s = tmaterialize(e.s)
    if _pallas_supported(model):
        A, a, Q = t.As.value, t.offs.value, t.Qs.value
    else:
        A, a, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    return (A, a, Q, e.H.value, e.h.value, s, y, t.x0.mean, t.x0.cov)


def logpdf(model, y, *, n_blocks=None, fused=None):
    """Block-parallel logpdf. `fused=None` runs the kernels when the model's
    tensors are on a CUDA device (the reference's `pallas=None` picks Pallas
    on the TPU); `fused=False` runs the plain PyTorch blocked schedule: for
    Fill models K1-K3's plain versions, for per-step (A, a, Q) the lane path
    (the reference's `_logpdf_xla` with `pallas=False`). Models the kernels
    do not take (D > 3, per-step H or h) run the matrix path."""
    _check_general_model(model)
    if not _streamed_supported(model):
        return _logpdf_matrix(model, y, _blocks(model, n_blocks, False))
    fused = _use_kernels(model, fused)
    B = _blocks(model, n_blocks, fused or _pallas_supported(model))
    leaves = _fused_leaves(model, y)
    if fused:
        return _LogpdfFused.apply(B, *leaves)
    return _logpdf_fused_impl(*leaves, B, PLAIN_PHASES)


def _fwd_grad_supported(model, model_tangents) -> bool:
    """The models `logpdf_fwd_grad` takes: a primal the constant-parameter
    kernels take, and tangents of Fill leaves, the noise tangent included."""
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
    comps, chunk_comps = kernels.phase1_jvp(y_main, s_main, rows, D, k)
    starts = kernels.phase2_jvp_starts(comps, priors, D, k)
    totals = kernels.phase3_jvp_lml(y_main, s_main, rows, starts, D, k, chunk_comps).sum(dim=1)
    return totals[0] + comp, totals[1:]


# ---------------------------------------------------------------------------
# The matrix path (the reference's general block schedule for D > 3):
# elements, states and transitions as batched (B, ...) tensors
# ---------------------------------------------------------------------------

def _mT(X):
    return X.transpose(-1, -2)


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _blocked_leaves(model, y, B):
    """((A, a, Q, H, h, s, y) as (L, B, ...) tensors, compensation): the
    reference's `_pad_tail` and `_split_tree`. A Fill leaf pads with its own
    value, a per-step one with an identity transition, zero offset, noise
    and emission; s pads with LARGE_VAR and y with 0."""
    t, e = model.trans, model.emis
    N, D = len(model), model.latent_dim
    L = -(-N // B)
    n_pad = B * L - N
    dtype, device = model.dtype, model.device

    def pad(leaf, pad_value):
        x = tmaterialize(leaf)
        value = leaf.value if is_fill(leaf) else pad_value
        x = torch.cat([x, value.to(x).expand(n_pad, *value.shape)])
        return x.reshape(B, L, *x.shape[1:]).transpose(0, 1)

    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    leaves = (pad(t.As, torch.eye(D, dtype=dtype, device=device)), pad(t.offs, z(D)),
              pad(t.Qs, z(D, D)), pad(e.H, z(D)), pad(e.h, z()),
              pad(e.s, torch.tensor(LARGE_VAR, dtype=dtype, device=device)), pad(y, z()))
    return leaves, n_pad * 0.5 * math.log(2.0 * math.pi * LARGE_VAR)


def _step_elements(A, a, Q, H, h, s, y):
    """Filtering elements of scalar-emission steps, batched over leading
    axes (the scalar branch of the reference's `_step_element`)."""
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    S = torch.einsum("...i,...ij,...j->...", H, Q, H) + s
    K = _mv(Q, H) / S[..., None]
    ImKH = I - K[..., :, None] * H[..., None, :]
    resid = y - ((H * a).sum(-1) + h)
    w = torch.einsum("...ji,...j->...i", A, H)
    return (ImKH @ A, a + K * resid[..., None], symmetrize(ImKH @ Q),
            w * (resid / S)[..., None], symmetrize(w[..., :, None] * w[..., None, :]
                                                   / S[..., None, None]))


def _minv(C, J):
    """(I + C J)^{-1}, batched; C, J symmetric PSD (the reference's
    `assoc._minv`): a plain inverse for D <= 3, else a Cholesky congruence
    with the reference's jitter, C = Lc Lc^T, (I + C J)^{-1} =
    Lc (I + Lc^T J Lc)^{-1} Lc^{-1}."""
    D = C.shape[-1]
    I = torch.eye(D, dtype=C.dtype, device=C.device)
    if D <= 3:
        return torch.linalg.inv(I + C @ J)
    Cs = symmetrize(C)
    if C.dtype == torch.float64:
        eps = 1e-10
    else:  # scaled to the covariance's magnitude, as the reference does in float32
        eps = 3e-6 * torch.diagonal(Cs, dim1=-2, dim2=-1).abs().amax(-1).clamp_min(1.0)
        eps = eps[..., None, None]
    Lc = torch.linalg.cholesky(Cs + eps * I)
    Ls = torch.linalg.cholesky(symmetrize(_mT(Lc) @ J @ Lc) + I)
    Lc_inv = torch.linalg.solve_triangular(Lc, I.expand(Lc.shape), upper=False)
    return Lc @ torch.cholesky_solve(Lc_inv, Ls)


def _combine_filter(e_i, e_j):
    """Filtering elements combined, e_i first (the reference's
    `assoc._combine_filter`), batched."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    M = _minv(C_i, J_j)
    AjM = A_j @ M
    MAi = M @ A_i
    return (A_j @ MAi, _mv(AjM, b_i + _mv(C_i, eta_j)) + b_j,
            symmetrize(AjM @ C_i @ _mT(A_j) + C_j),
            _mv(_mT(MAi), eta_j - _mv(J_j, b_i)) + eta_i,
            symmetrize(_mT(MAi) @ J_j @ A_i + J_i))


def _combine_affine(e_i, e_j):
    """Affine-Gaussian maps composed, e_i first (`assoc._combine_affine`)."""
    A_i, b_i, C_i = e_i
    A_j, b_j, C_j = e_j
    return A_j @ A_i, _mv(A_j, b_i) + b_j, symmetrize(A_j @ C_i @ _mT(A_j) + C_j)


def _associative_scan(combine, elems):
    """Inclusive prefix of the tuple `elems` along axis 0 in the association
    of the reference's `jax.lax.associative_scan`: adjacent pairs combined,
    their prefix recursively, then the even positions from it; log2 depth,
    the earlier operand always on the left."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine(tuple(x[0:-1:2] for x in elems),
                                             tuple(x[1::2] for x in elems)))
    later = tuple(x[2::2] for x in elems)
    even = combine(tuple(x[:-1] for x in odd) if n % 2 == 0 else odd, later)
    out = []
    for x, e, o in zip(elems, even, odd):
        e = torch.cat([x[:1], e])
        merged = x.new_empty((e.shape[0] + o.shape[0], *x.shape[1:]))
        merged[0::2], merged[1::2] = e, o
        out.append(merged)
    return tuple(out)


def _prefix_from(prior, aggs, combine):
    """Exclusive block starts (m, P), each (B, ...): the prefix of the
    prior element and the B aggregates, without its last entry."""
    elems = tuple(torch.cat([p, a]) for p, a in zip(prior, aggs))
    pref = _associative_scan(combine, elems)
    return pref[1][:-1], pref[2][:-1]


def _matrix_starts(model, blocked):
    """Phases 1 and 2 of the matrix path: each block's fold of its step
    elements from the identity, then the prefix with the prior element
    (0, m0, P0, 0, 0) in front; the (B, D), (B, D, D) block starts."""
    A, a, Q, H, h, s, y = blocked
    L, B, D = A.shape[0], A.shape[1], model.latent_dim
    dtype, device = model.dtype, model.device
    zmat = torch.zeros((B, D, D), dtype=dtype, device=device)
    zvec = torch.zeros((B, D), dtype=dtype, device=device)
    agg = (torch.eye(D, dtype=dtype, device=device).expand(B, D, D), zvec, zmat, zvec, zmat)
    for l in range(L):
        agg = _combine_filter(agg, _step_elements(A[l], a[l], Q[l], H[l], h[l], s[l], y[l]))
    x0 = model.trans.x0
    prior = (zmat[:1], x0.mean[None].to(dtype), symmetrize(x0.cov)[None].to(dtype),
             zvec[:1], zmat[:1])
    return _prefix_from(prior, agg, _combine_filter)


def _kalman_steps(m, P, A, a, Q, H, h, s, y):
    """Predict and scalar update of every block, (B, ...) tensors (the
    reference's `lgc.predict` and `lgc.posterior_and_lml_scalar`)."""
    m = _mv(A, m) + a
    P = symmetrize(A @ symmetrize(P) @ _mT(A) + Q)
    V = torch.einsum("...j,...jk->...k", H, P)
    sqrtS = torch.sqrt((V * H).sum(-1) + s)
    Bv = V / sqrtS[..., None]
    alpha = (y - ((H * m).sum(-1) + h)) / sqrtS
    lml = -0.5 * (_LOG2PI + 2.0 * torch.log(sqrtS) + alpha * alpha)
    return m + Bv * alpha[..., None], P - Bv[..., :, None] * Bv[..., None, :], lml


def _logpdf_matrix(model, y, B):
    """lml on the matrix path (the reference's `_logpdf_xla` for models the
    lane path does not take)."""
    blocked, comp = _blocked_leaves(model, y, B)
    m, P = _matrix_starts(model, blocked)
    acc = m.new_zeros(m.shape[0])
    for step in zip(*blocked):
        m, P, lml = _kalman_steps(m, P, *step)
        acc = acc + lml
    return acc.sum() + comp


def _filter_matrix(model, y, B) -> Gaussian:
    """Filtering states of every step on the matrix path (the reference's
    `block.filter_`), ((N, D), (N, D, D))."""
    blocked, _ = _blocked_leaves(model, y, B)
    m, P = _matrix_starts(model, blocked)
    ms, Ps = [], []
    for step in zip(*blocked):
        m, P, _ = _kalman_steps(m, P, *step)
        ms.append(m)
        Ps.append(P)
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
    y_main, s_main, _ = _blocked_streams(y, tmaterialize(e.s), B)
    if _pallas_supported(model):
        phases = KERNEL_STATE_PHASES if use else PLAIN_STATE_PHASES
        rows = {}
        packed = kernels.pack_params(t.As.value, t.offs.value, t.Qs.value, e.H.value,
                                     e.h.value, model.dtype)
    else:
        phases = STREAMED_STATE_PHASES if use else PLAIN_STATE_PHASES
        rows = dict(trans_rows=_rows_blocked(*_iteration_view(model), B))
        packed = _emission_params(e.H.value, e.h.value, model.dtype)
    comps, _ = phases.phase1_aggregate(y_main, s_main, packed, D, **rows)
    starts = phases.phase2_starts(comps, t.x0.mean, symmetrize(t.x0.cov), D)
    return _unblock_states(phases.phase3_states(y_main, s_main, packed, starts, D, **rows), N)


def filter_(model, y, *, n_blocks=None, fused=None) -> Gaussian:
    """Filtering distributions at every step on the blocked schedule; the
    padding steps observe nothing, so the real steps' states are exact."""
    _check_general_model(model)
    if not _streamed_supported(model):
        return _filter_matrix(model, y, _blocks(model, n_blocks, False))
    return _comps_to_gaussian(_filter_state_comps(model, y, n_blocks, fused), model.latent_dim)


def _mat_to_array(M):
    """Component matrix of (N,) tensors -> (N, D, D)."""
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def posterior(model, y, *, n_blocks=None, fused=None):
    """The smoother as a reverse-ordered LGSSM (models.lgssm.posterior) on
    the blocked schedule. For the models the filtering kernels take: the
    filtering states from K1, K2, K7, then the dynamics of every step
    inverted in plain tensor ops on (N,) component vectors, with the
    adjugate inverse of ops/lanes.py and POSTERIOR_JITTER (the reference's
    `_posterior_pallas`). Otherwise the matrix filter and the batched
    Cholesky inversion of models.lgssm (the reference's `block.posterior`)."""
    _check_general_model(model)
    if not _streamed_supported(model):
        return _reversed_model_matrix(
            model, _filter_matrix(model, y, _blocks(model, n_blocks, False)))
    return _reversed_model(model, _filter_state_comps(model, y, n_blocks, fused))


def _components(X, D):
    """Component matrix of a (D, D) value or an (N, D, D) per-step tensor."""
    return tuple(tuple(X[..., r, c] for c in range(D)) for r in range(D))


def _reversed_model(model, xf):
    """The reverse-ordered posterior LGSSM from the (SD, N) filtering states,
    the transitions constant (0-dim components) or per step ((N,) ones)."""
    D = model.latent_dim
    t, x0 = model.trans, model.trans.x0
    mf, Pf = kernels._state_rows_to_tuple(xf.unbind(0), D)

    def prev(comp, init):  # the state before each step: x0, then the filtering states
        return torch.cat([init.reshape(1), comp[:-1]])

    x0P = symmetrize(x0.cov)
    m_prev = tuple(prev(mf[i], x0.mean[i]) for i in range(D))
    P_prev = tuple(tuple(prev(Pf[r][c], x0P[r, c]) for c in range(D)) for r in range(D))
    value = lambda leaf: leaf.value if is_fill(leaf) else leaf
    A_c, Q_c = _components(value(t.As), D), _components(value(t.Qs), D)
    a_c = tuple(value(t.offs)[..., i] for i in range(D))
    mp = lanes.vadd(lanes.mv(A_c, m_prev), a_c)
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


def _reversed_model_matrix(model, xf: Gaussian):
    """The reverse-ordered posterior LGSSM from the stacked filtering states:
    the predicted state of every step and `models.lgssm._invert_dynamics`,
    batched over the N steps."""
    from ..models.lgssm import _invert_dynamics

    t, x0 = model.trans, model.trans.x0
    prev = Gaussian(torch.cat([x0.mean[None].to(xf.mean), xf.mean[:-1]]),
                    torch.cat([symmetrize(x0.cov)[None].to(xf.cov), xf.cov[:-1]]))
    F, c, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    xp = Gaussian(_mv(F, prev.mean) + c, symmetrize(F @ symmetrize(prev.cov) @ _mT(F) + Q))
    A_rev, a_rev, Q_rev = _invert_dynamics(prev, xp, F)
    trans = GaussMarkov(As=A_rev, offs=a_rev, Qs=Q_rev,
                        x0=Gaussian(xf.mean[-1], xf.cov[-1]), forward=False)
    return LGSSM(trans, model.emis)


def _marginals_supported(model) -> bool:
    """The models the affine kernels take: D <= 3 (any ordering, Fill or
    per-step parameters)."""
    return model.latent_dim <= 3


def _iteration_view(model):
    """The model's transitions (F, c, Q), each (N, ...), in iteration order.

    A forward model transitions, then emits, so state t includes transition
    t. A reverse model emits, then transitions: flipped to iteration order
    and shifted by one with the identity map first (its x0 is already the
    state at the last step), dropping the transition out of step 0 (the
    reference's `assoc._iteration_view`)."""
    t = model.trans
    F, c, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    if t.forward:
        return F, c, Q
    D = model.latent_dim
    eye = torch.eye(D, dtype=F.dtype, device=F.device)
    return (torch.cat([eye[None], F.flip(0)[:-1]]), torch.cat([c.new_zeros(1, D), c.flip(0)[:-1]]),
            torch.cat([Q.new_zeros(1, D, D), Q.flip(0)[:-1]]))


def _affine_comps_iteration(model, B):
    """The model's transitions in iteration order as the affine kernels'
    (KT, L, B) rows, L = ceil(N / B), padded with identity maps."""
    return _rows_blocked(*_iteration_view(model), B)


def latent_marginal_comps(model, *, n_blocks=None, fused=None):
    """(SD, N) latent marginals in time order: on K8 -> K9 -> K10 for
    D <= 3, on the matrix `affine_prefix_states` otherwise."""
    if not _marginals_supported(model):
        F, c, Q = _iteration_view(model)
        x0 = model.trans.x0
        x = affine_prefix_states(F, c, Q, x0.mean, x0.cov, n_blocks=n_blocks)
        comps = _gaussian_to_comps(x)
        return comps if model.trans.forward else comps.flip(1)
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
    B = min(n_blocks or _default_blocks(N, D), N)
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
    m, P = _prefix_from(prior, agg, _combine_affine)
    ms, Ps = [], []
    for l in range(L):
        m = _mv(Fb[l], m) + cb[l]
        P = symmetrize(Fb[l] @ P @ _mT(Fb[l]) + Qb[l])
        ms.append(m)
        Ps.append(P)
    return Gaussian(torch.stack(ms, 1).reshape(-1, D)[:N],
                    torch.stack(Ps, 1).reshape(-1, D, D)[:N])


def _affine_states(model, params, fused):
    """(SD, N) states in time order from the model's (KT, L, B) iteration
    rows, on K8 -> K9 -> K10."""
    phases = KERNEL_AFFINE_PHASES if _use_kernels(model, fused) else PLAIN_AFFINE_PHASES
    D, x0 = model.latent_dim, model.trans.x0
    agg, chunk_aggs = phases.affine_phase1(params, D)
    starts = phases.affine_phase2_starts(agg, x0.mean, symmetrize(x0.cov), D)
    comps = _unblock_states(phases.affine_phase3_states(params, starts, D, chunk_aggs),
                            len(model))
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
