"""Block-parallel Kalman logpdf on the fused phase kernels
(temporalgps_tpu/ops/block.py, the Pallas path `_logpdf_pallas_impl`).

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

from ..config import LARGE_VAR
from ..models.emissions import ScalarEmissions
from ..models.missings import fill_in_missings, volume_compensation
from ..utils.fill import is_fill, tmaterialize
from ..utils.psd import symmetrize
from . import kernels


class _Phases(NamedTuple):
    phase1_aggregate: Callable
    phase2_starts: Callable
    phase3_lml: Callable


KERNEL_PHASES = _Phases(kernels.phase1_aggregate, kernels.phase2_starts, kernels.phase3_lml)
PLAIN_PHASES = _Phases(
    kernels.phase1_aggregate_plain, kernels.phase2_starts_plain, kernels.phase3_lml_plain
)

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
    if fused is None:
        fused = model.device.type == "cuda"
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
