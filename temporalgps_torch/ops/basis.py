"""The basis engine (temporalgps_tpu/ops/basis.py): a kernel's deterministic
summands as basis functions with Gaussian weights, marginalised in
innovations form against the model of its stochastic summands.

A deterministic summand (Cosine, Constant, ApproxPeriodic: no process
noise) is f_det(t) = M(t) w, w ~ N(0, P0), M in closed form
(gp.kernels.det_basis_columns). So

    y ~ N(mu + M w, V),   V = K_stoch + diag(s),   w ~ N(0, P0),

and w is marginalised by Woodbury. The Kalman filter of the reduced
stochastic model factors V = L S L^T; with e = L^{-1} c the innovations of a
column c and S the innovation variances, every Woodbury term is a gram of
innovations,

    C[i, j] = c_i^T V^{-1} c_j = sum_t e_i,t e_j,t / S_t,

for all columns [y - mu | M] in one filter pass: the gain and the covariance
recursion do not depend on the data, so the mean recursion carries R
columns instead of one. With L0 = chol(P0), C_b the basis block of C, b its
column against y and T = L0^T C_b L0, u = L0^T b:

    lml = -1/2 [C_yy - u^T (I + T)^{-1} u + logdet V + logdet(I + T) + N log 2 pi].

No Q^{-1} and no collapsing covariance: the exact lml of the full model.

Sub-engines: "sequential" (the ground truth, a loop over time), "block"
(ops/block.py's general schedule with (D, R) matrix offsets b and eta, on
the port's jitter-free element inverse `assoc._minv`) and "steady" (an exact
float64 head on "block", then the constant-gain late segment of
ops/steady.py on kron(I_R, G)). All in plain PyTorch on either device: the
reference has no Pallas kernel here.
"""

import math

import torch

from ..config import LARGE_VAR
from ..models import emissions as em
from ..models import lgssm as lg
from ..utils import psd
from ..utils.psd import symmetrize
from . import assoc, block


def _mT(X):
    return X.transpose(-1, -2)


def _check_model(model):
    if not (model.trans.forward and isinstance(model.emis, em.ScalarEmissions)):
        raise ValueError("the basis engine takes forward models with scalar emissions")


def _kalman_step_multi(m, P, gram, ld, A, a, Q, H, h, s, yt, w_off):
    """Predict and update of the (..., D, R) column means and the shared
    (..., D, D) covariance, accumulating the innovations' gram (..., R, R)
    and log-variance (...,); batched over leading axes."""
    I = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    m = A @ m + a[..., :, None] * w_off
    P = symmetrize(A @ P @ _mT(A) + Q)
    PH = (P @ H[..., :, None])[..., 0]
    S = (H * PH).sum(-1) + s
    e = yt - ((H[..., :, None] * m).sum(-2) + h[..., None] * w_off)
    gram = gram + e[..., :, None] * e[..., None, :] / S[..., None, None]
    ld = ld + torch.log(S)
    K = PH / S[..., None]
    m = m + K[..., :, None] * e[..., None, :]
    P = symmetrize((I - K[..., :, None] * H[..., None, :]) @ P)
    return m, P, gram, ld


def grams_sequential(model, Y, w_off, *, final_state=False):
    """(logdet V, C), C[i, j] = c_i^T V^{-1} c_j over the columns of Y (N, R).
    `w_off` (R,) is 1 for the columns that see the model's offsets a and h
    (the data) and 0 for the rest (the basis columns). Forward models with
    scalar emissions. `final_state=True` also returns the last filtering
    means (D, R) and covariance (D, D)."""
    _check_model(model)
    t = model.trans
    dtype, device = model.dtype, model.device
    N, R = len(model), Y.shape[-1]
    Y, w_off = Y.to(dtype), w_off.to(dtype)
    m = t.x0.mean[:, None] * w_off
    P = symmetrize(t.x0.cov)
    gram = torch.zeros(R, R, dtype=dtype, device=device)
    ld = torch.zeros((), dtype=dtype, device=device)
    e = model.emis
    for A, a, Q, H, h, s, yt in zip(*(lg._steps(leaf, N) for leaf in (
            t.As, t.offs, t.Qs, e.H, e.h, e.s)), Y.unbind(0)):
        m, P, gram, ld = _kalman_step_multi(m, P, gram, ld, A, a, Q, H, h, s, yt, w_off)
    if final_state:
        return ld, gram, m, P
    return ld, gram


def _step_element_multi(A, a, Q, H, h, s, yt, w_off):
    """The filtering element of a step (block.step_elements' algebra for
    scalar emissions) with (..., D, R) offsets b and eta; batched."""
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    S = torch.einsum("...i,...ij,...j->...", H, Q, H) + s
    K = (Q @ H[..., :, None])[..., 0] / S[..., None]
    ImKH = I - K[..., :, None] * H[..., None, :]
    resid = yt - ((H * a).sum(-1) + h)[..., None] * w_off  # (..., R)
    b = a[..., :, None] * w_off + K[..., :, None] * resid[..., None, :]
    w = torch.einsum("...ji,...j->...i", A, H)  # A^T H
    eta = w[..., :, None] * (resid / S[..., None])[..., None, :]
    J = symmetrize(w[..., :, None] * w[..., None, :] / S[..., None, None])
    return ImKH @ A, b, symmetrize(ImKH @ Q), eta, J


def _combine_filter_multi(e_i, e_j):
    """`assoc._combine_filter`, e_i first, with (..., D, R) offsets b and
    eta; the jitter-free inverse of I + C_i J_j (`assoc._minv`)."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    M = assoc._minv(C_i, J_j)
    AjM = A_j @ M
    MAi = M @ A_i
    return (A_j @ MAi, AjM @ (b_i + C_i @ eta_j) + b_j,
            symmetrize(AjM @ C_i @ _mT(A_j) + C_j),
            _mT(MAi) @ (eta_j - J_j @ b_i) + eta_i,
            symmetrize(_mT(MAi) @ J_j @ A_i + J_i))


def grams_block(model, Y, w_off, *, n_blocks=None, final_state=False):
    """`grams_sequential` on the block schedule: the series padded to B
    blocks of L steps (`block._blocked_leaves`: the pad steps observe
    nothing, noise LARGE_VAR, y = 0); phase 1 folds each block's
    multi-column elements, phase 2 prefixes the B aggregates behind the
    prior element for the exact block starts, phase 3 runs the Kalman
    recursion in every block at once and sums the blocks' grams and
    log-variances. Each pad step adds log(LARGE_VAR) to logdet V (up to
    O(H P H^T / LARGE_VAR)), taken off in closed form. `final_state=True`
    (B must divide N: a pad step would carry the state past step N) also
    returns the last filtering means (D, R) and covariance (D, D)."""
    _check_model(model)
    t = model.trans
    dtype, device = model.dtype, model.device
    N, D, R = len(model), model.latent_dim, Y.shape[-1]
    Y, w_off = Y.to(dtype), w_off.to(dtype)
    B = min(n_blocks or block._default_blocks(N), N)
    if final_state and N % B:
        raise ValueError(f"grams_block(final_state=True) needs n_blocks | N, got {B} and {N}")
    (A, a, Q, e, y), _ = block._blocked_leaves(model, Y, B)
    L = A.shape[0]
    n_pad = B * L - N
    step = lambda l: (A[l], a[l], Q[l], e.H[l], e.h[l], e.s[l], y[l])

    # Each block's fold from its first element (the identity element in
    # front of it would combine to the same tuple).
    agg = _step_element_multi(*step(0), w_off)
    for l in range(1, L):
        agg = _combine_filter_multi(agg, _step_element_multi(*step(l), w_off))
    x0 = t.x0
    z = lambda *shape: torch.zeros(1, *shape, dtype=dtype, device=device)
    prior = (z(D, D), (x0.mean[:, None] * w_off)[None], symmetrize(x0.cov)[None], z(D, R),
             z(D, D))
    pref = assoc._associative_scan(_combine_filter_multi,
                                   tuple(torch.cat([p, g]) for p, g in zip(prior, agg)))
    m, P = pref[1][:-1], pref[2][:-1]

    gram = torch.zeros(B, R, R, dtype=dtype, device=device)
    ld = torch.zeros(B, dtype=dtype, device=device)
    for l in range(L):
        m, P, gram, ld = _kalman_step_multi(m, P, gram, ld, *step(l), w_off)
    ld_all = ld.sum() - n_pad * math.log(LARGE_VAR)
    if final_state:
        return ld_all, gram.sum(0), m[-1], P[-1]
    return ld_all, gram.sum(0)


def grams_steady(model, Y, w_off, *, n_warmup=None, n_blocks=None, fwd_mode=False):
    """`grams_sequential` on the steady engine (ops/steady.py's contract: an
    all-Fill model, fully observed data; choose n_warmup >~ 5 / (lambda dt),
    steady.suggest_warmup). The first k steps (n_warmup rounded up to a
    multiple of 64) run exactly on "block" in float64, at B_w = max(64,
    k // 64) blocks halved until B_w divides k (~64 steps a block). Past k
    the gain is the converged one, from `steady._steady_ops` seeded with the
    head's last covariance, and every column's filtered mean follows m_t =
    G m_{t-1} + w_off c_w + K y_t: all R columns as one flat (R D)-state
    recursion with kron(I_R, G) (`steady.affine_const_states`; no (M, D, R)
    tensor), the late innovations' gram one (R, M) x (M, R) product over
    the constant S. `fwd_mode=True` runs the late segment without its
    autograd.Function, for forward-mode gradients."""
    from . import steady as sd

    _check_model(model)
    sd._check(model)
    N, D, R = len(model), model.latent_dim, Y.shape[-1]
    dtype = model.dtype
    Y, w_off = Y.to(dtype), w_off.to(dtype)
    k = sd._round_warmup(n_warmup or sd.DEFAULT_WARMUP, N, base=64)
    if k >= N:
        return grams_block(model, Y, w_off, n_blocks=n_blocks)
    B_w = max(64, k // 64)
    while k % B_w:
        B_w //= 2
    hi = torch.float64
    ld_w, gram_w, m_k, P_k = grams_block(assoc.widened(sd._trim(model, k)), Y[:k].to(hi),
                                         w_off.to(hi), n_blocks=B_w, final_state=True)

    ops = sd._steady_ops(model, dtype, N, n_warmup=k, P_seed=P_k)
    y_late = Y[k:]  # (M, R)
    G, K, c_w = ops["G"], ops["K"], ops["c_w"]
    A0, a0, H, h, S = ops["A0"], ops["a0"], ops["H"], ops["h"], ops["S"]
    I_R = torch.eye(R, dtype=dtype, device=Y.device)
    # Flat column-major states: column r's at [r D, (r + 1) D).
    WF = y_late @ torch.kron(I_R, K[:, None]).T + (w_off[:, None] * c_w[None, :]).reshape(-1)
    m0 = m_k.to(dtype)  # (D, R)
    meansF = sd.affine_const_states(torch.kron(I_R, G), WF, m0.T.reshape(-1),
                                    fwd_mode=fwd_mode)  # (M, R D)
    # e_t = y_t - (H (A0 m_{t-1} + a0 w_off) + h w_off)
    g = A0.T @ H
    proj_prev = torch.cat([(g @ m0)[None], meansF[:-1] @ torch.kron(I_R, g[:, None])])
    E = y_late - proj_prev - (H @ a0 + h) * w_off
    gram = gram_w.to(dtype) + (E.T @ E) / S
    return ld_w.to(dtype) + (N - k) * ops["logdetS"], gram


def marginalised_lml(ld, gram, P0, N, dtype):
    """The lml of y under V + M P0 M^T from the innovation grams of [y | M]:
    gram[0, 0] = y^T V^{-1} y, gram[1:, 0] = M^T V^{-1} y, gram[1:, 1:] =
    M^T V^{-1} M, ld = logdet V. In the Cholesky congruence T = L0^T C_b L0,
    L0 = chol(P0), every solve is positive definite."""
    q_y, b = gram[0, 0], gram[1:, 0]
    C_b = symmetrize(gram[1:, 1:])
    d = C_b.shape[-1]
    if d == 0:
        return -0.5 * (q_y + ld + N * math.log(2.0 * math.pi))
    L0 = psd.cholesky(symmetrize(torch.as_tensor(P0, dtype=dtype, device=gram.device)))
    T = symmetrize(_mT(L0) @ C_b @ L0)
    Lt = psd.cholesky(T + torch.eye(d, dtype=dtype, device=gram.device))
    z = psd.tri_solve(Lt, _mT(L0) @ b[:, None])
    logdet_IT = 2.0 * torch.log(torch.diagonal(Lt)).sum()
    return -0.5 * (q_y - (z * z).sum() + ld + logdet_IT + N * math.log(2.0 * math.pi))


def logpdf_basis(model, Y, w_off, P0, *, engine="block", n_blocks=None, n_warmup=None,
                 fwd_mode=False):
    """The marginalised lml: `model` the reduced stochastic LGSSM, Y the
    (N, 1 + d) columns [y | M] (column 0 the data), w_off their offset mask,
    P0 the (d, d) prior covariance of the basis weights. `engine`:
    "sequential", "block" or "steady" (`grams_steady`, its contract)."""
    if engine == "sequential":
        ld, gram = grams_sequential(model, Y, w_off)
    elif engine == "steady":
        ld, gram = grams_steady(model, Y, w_off, n_warmup=n_warmup, n_blocks=n_blocks,
                                fwd_mode=fwd_mode)
    elif engine == "block":
        ld, gram = grams_block(model, Y, w_off, n_blocks=n_blocks)
    else:
        raise ValueError(f"the basis engine has no sub-engine {engine!r}")
    return marginalised_lml(ld, gram, P0, len(model), model.dtype)
