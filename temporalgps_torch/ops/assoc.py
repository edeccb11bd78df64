"""Parallel-prefix Kalman filtering and smoothing (temporalgps_tpu/ops/assoc.py):
engine="parallel", and the element algebra that the block engine's matrix
path (ops/block.py) and the square-root engine (ops/sqrt.py) share.

A filtering element represents p(x_k | x_j, y_{j+1:k}) as (A, b, C, eta, J):

    x_k | x_j ~ N(A x_j + b, C)   reweighted by   exp(eta' x_j - x_j' J x_j / 2)

Composition (i earlier, j later), with M = (I + C_i J_j)^{-1}:

    A = A_j M A_i
    b = A_j M (b_i + C_i eta_j) + b_j
    C = A_j M C_i A_j' + C_j
    eta = A_i' M' (eta_j - J_j b_i) + eta_i
    J = A_i' M' J_j A_i + J_i

The prior enters as the element (0, m0, P0, 0, 0), so the inclusive prefix at
position k is the filtering distribution after step k. All N + 1 elements are
combined by `_associative_scan`, in the association of the reference's
`jax.lax.associative_scan`: log2(N) levels of batched (N, D, D) tensor ops,
on the card as on the CPU (the reference runs the same scan in XLA; no Pallas
kernel). Affine-Gaussian maps (F, c, Q) compose the same way for marginals
and samples.

Both orderings share one algebra: a reverse-ordered model (the smoother's
posterior), flipped to iteration order, has its transitions shifted by one
with the identity first (`_iteration_view`), which turns emit-then-transition
into transition-then-emit. A step's element (`step_elements`) takes any
emission container of models/emissions.py: a scalar observation, a vector
one with dense noise (the Cholesky factor of its innovation covariance) or
with diagonal noise (every factor in the input space, `element_dense_diag`;
a bottleneck's composed to the observations, `emissions.diag_noise_params`).
"""

import torch

from ..config import IDENT_EPS, POSTERIOR_JITTER, RAND_JITTER
from ..models import emissions as em
from ..models.gauss_markov import GaussMarkov
from ..models.lgssm import LGSSM, _invert_dynamics
from ..utils import psd
from ..utils.fill import Fill, is_fill, tmaterialize
from ..utils.gaussian import Gaussian
from ..utils.psd import symmetrize


def _mT(X):
    return X.transpose(-1, -2)


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


# ---------------------------------------------------------------------------
# The element algebra
# ---------------------------------------------------------------------------

# The state dim above which `_minv` forms a float32 inverse in float64 (the
# cut lies between the measured D = 30 and D = 150).
MINV_WIDE_ABOVE_D = 32


def _minv(C, J):
    """(I + C J)^{-1}, batched; C, J symmetric PSD. I + C J is nonsingular
    (the eigenvalues of C J are real and non-negative), so its LU inverse is
    well posed where a Cholesky factor of C is not (C is singular at the
    prior element and near-singular at small time steps): no jitter, any D.
    The reference takes a Cholesky congruence with a jitter for D > 3,
    which moved the float32 posterior means of Matern52() + Matern32() by
    7.7e-2 at N = 2000; this inverse, 5.8e-5 (probes/torch_minv_repair.py).

    Above D = MINV_WIDE_ABOVE_D a float32 inverse is formed in float64 and
    stored in float32. Both inverses in one call on the card
    (probes/torch_c4_blocks.py, "NVIDIA H100 80GB HBM3, 700.00 W"; float32
    ms, LU -> formed in float64): at the space-time model c4 (D = 150)
    "parallel" `logpdf` 75.4 -> 58.4, "block" 84.8 -> 64.7, and the block
    engine's posterior means 3.9e-3 -> 1.5e-3 from the float32 problem
    solved in float64, the parallel engine's 9.1e-4 -> 1.1e-3 (the
    sequential engine's, with no inverse: 9.7e-4); at D = 30 `logpdf` 24.5
    -> 30.0 ("parallel"), means within 1.3x; at D = 6 `logpdf` 131.8 ->
    159.3, at D = 3 ("parallel", N = 1M) 80.2 -> 102.2, for no gain."""
    if C.dtype != torch.float32 or C.shape[-1] <= MINV_WIDE_ABOVE_D:
        return torch.linalg.inv(torch.eye(C.shape[-1], dtype=C.dtype, device=C.device) + C @ J)
    eye = torch.eye(C.shape[-1], dtype=torch.float64, device=C.device)
    return torch.linalg.inv(eye + C.double() @ J.double()).float()


def _combine_filter(e_i, e_j):
    """Filtering elements combined, e_i first, batched."""
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
    """Affine-Gaussian maps x -> N(A x + b, C) composed, e_i first."""
    A_i, b_i, C_i = e_i
    A_j, b_j, C_j = e_j
    return A_j @ A_i, _mv(A_j, b_i) + b_j, symmetrize(A_j @ C_i @ _mT(A_j) + C_j)


def _combine_affine_mean(e_i, e_j):
    """Affine maps x -> A x + b composed, e_i first (a sample's states)."""
    A_i, b_i = e_i
    A_j, b_j = e_j
    return A_j @ A_i, _mv(A_j, b_i) + b_j


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


# ---------------------------------------------------------------------------
# Iteration-order views of an LGSSM
# ---------------------------------------------------------------------------

def _flip(x):
    """A tensor, or each of a tuple or Gaussian's, flipped along time."""
    if isinstance(x, Gaussian):
        return Gaussian(x.mean.flip(0), x.cov.flip(0))
    if isinstance(x, tuple):
        return tuple(t.flip(0) for t in x)
    return x.flip(0)


def _unflip(model, x):
    """Values in iteration order -> time order."""
    return x if model.trans.forward else _flip(x)


def _iteration_view(model):
    """The model's transitions (F, c, Q), each (N, ...), in iteration order,
    as the elements take them.

    A forward model transitions, then emits, so state t includes transition
    t. A reverse model emits, then transitions: flipped to iteration order
    and shifted by one with the identity map first (its x0 is already the
    state at the last step), dropping the transition out of step 0 (the
    element view of the reference's `_iteration_view`)."""
    t = model.trans
    F, c, Q = (tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    if t.forward:
        return F, c, Q
    D = model.latent_dim
    eye = torch.eye(D, dtype=F.dtype, device=F.device)
    return (torch.cat([eye[None], F.flip(0)[:-1]]), torch.cat([c.new_zeros(1, D), c.flip(0)[:-1]]),
            torch.cat([Q.new_zeros(1, D, D), Q.flip(0)[:-1]]))


def _iteration_order(model, y=None):
    """((F, c, Q) unshifted, the emissions, y), each leaf (N, ...), in
    iteration order: the rest of the reference's `_iteration_view`."""
    t = model.trans
    trans = tuple(tmaterialize(leaf) for leaf in (t.As, t.offs, t.Qs))
    emis = em.map_leaves(tmaterialize, model.emis)
    if not t.forward:
        trans, emis = _flip(trans), em.map_leaves(_flip, emis)
        y = None if y is None else y.flip(0)
    return trans, emis, y


def _sample_maps(model, eps_t):
    """(F, b), each (N, ...): the iteration view's maps x -> F x + b of the
    sample that the normals eps_t (N, D, indexed by time) give,
    b = c + chol(Q + RAND_JITTER I) eps_t; a reverse-ordered model's eps_t
    flipped and shifted by one with a zero first, as its transitions are.
    The factor is `psd.sample_factor`'s (formed in float64), as in the
    sequential engine's `lgc.conditional_rand`: a Q that is not positive
    definite there raises. A
    forward model's constant (Fill) Q is factored once, the same factor as
    each of the sequential engine's steps takes (a batch of copies may be
    factored otherwise by the library: a Q as ill-conditioned as a space-time
    model's moves the sample by ~1e-7 between the two)."""
    F, c, Q = _iteration_view(model)
    if model.trans.forward and is_fill(model.trans.Qs):
        Q = model.trans.Qs.value
    elif not model.trans.forward:
        eps_t = torch.cat([torch.zeros_like(eps_t[:1]), eps_t.flip(0)[:-1]])
    return F, c + _mv(psd.sample_factor(Q, RAND_JITTER), eps_t)


# ---------------------------------------------------------------------------
# Elements and prefixes
# ---------------------------------------------------------------------------

def _prior_element(x0, D, like):
    """(0, m0, P0, 0, 0) with a leading axis of one."""
    z = like.new_zeros(1, D, D)
    return (z, x0.mean[None].to(like), symmetrize(x0.cov)[None].to(like), like.new_zeros(1, D), z)


def step_elements(F, c, Q, e, y):
    """Filtering elements of steps that transition by (F, c, Q), then
    observe y through the emissions e, batched over leading axes (the
    reference's `_filter_elements` and `block._step_element`)."""
    I = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    if isinstance(e, em.ScalarEmissions):
        H, h, s = e.H, e.h, e.s
        S = torch.einsum("...i,...ij,...j->...", H, Q, H) + s
        K = _mv(Q, H) / S[..., None]
        ImKH = I - K[..., :, None] * H[..., None, :]
        resid = y - ((H * c).sum(-1) + h)
        w = torch.einsum("...ji,...j->...i", F, H)  # F' H
        return (ImKH @ F, c + K * resid[..., None], symmetrize(ImKH @ Q),
                w * (resid / S)[..., None],
                symmetrize(w[..., :, None] * w[..., None, :] / S[..., None, None]))
    if (diag := em.diag_noise_params(e)) is not None:  # Large, Bottleneck
        return element_dense_diag(F, c, Q, *diag, y)
    H, d, R = e.H, e.h, e.S
    Ls = psd.cholesky(symmetrize(H @ Q @ _mT(H) + R))
    K = _mT(psd.chol_solve(Ls, H @ Q))  # (..., D, Dout)
    ImKH = I - K @ H
    resid = y - (_mv(H, c) + d)
    FtH = _mT(F) @ _mT(psd.chol_solve(Ls, H))  # F' H' S^{-1}
    return (ImKH @ F, c + _mv(K, resid), symmetrize(ImKH @ Q), _mv(FtH, resid),
            symmetrize(FtH @ H @ F))


def element_dense_diag(F, c, Q, H, d, s_diag, y):
    """The filtering element of vector emissions with diagonal noise R =
    diag(s_diag), every Cholesky factor and solve D x D (the reference's
    input-space factorisation): with Lp = chol(Q + IDENT_EPS I), Gram =
    H' R^{-1} H, u = H' R^{-1} r, T = Lp' Gram and Fm = I + T Lp,

        C = Lp Fm^{-1} Lp',   K r = Lp Fm^{-1} Lp' u,
        H' S^{-1} H = Gram - T' Fm^{-1} T,   H' S^{-1} r = u - T' Fm^{-1} Lp' u.

    Batched over leading axes."""
    I = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    q_isqrt = 1.0 / torch.sqrt(s_diag)
    Hw = H * q_isqrt[..., None]
    delta = q_isqrt * (y - (_mv(H, c) + d))
    Gram = symmetrize(_mT(Hw) @ Hw)
    u = _mv(_mT(Hw), delta)
    Lp = psd.cholesky(psd.add_jitter(symmetrize(Q), IDENT_EPS))
    T = _mT(Lp) @ Gram
    Lf = psd.cholesky(symmetrize(T @ Lp) + I)
    G = psd.tri_solve(Lf, _mT(Lp))
    FmiLpu = psd.chol_solve(Lf, _mv(_mT(Lp), u)[..., None])[..., 0]
    M1 = symmetrize(Gram - _mT(T) @ psd.chol_solve(Lf, T))
    w = u - _mv(_mT(T), FmiLpu)
    return (F - symmetrize(Q) @ (M1 @ F), c + _mv(Lp, FmiLpu), _mT(G) @ G, _mv(_mT(F), w),
            symmetrize(_mT(F) @ M1 @ F))


def _filter_elements(F, c, Q, e, y, x0):
    """Per-step filtering elements with the prior element in front: N + 1
    of each component."""
    elems = step_elements(F, c, Q, e, y)
    return tuple(torch.cat([p, x]) for p, x in zip(_prior_element(x0, F.shape[-1], F), elems))


def _filter_prefix(model, y):
    """Inclusive filtering prefixes in iteration order: (outs, (F_ev, c_ev,
    Q_ev), (F_it, c_it, Q_it), emissions, y_it), outs a Gaussian of N + 1
    entries, outs[0] = x0, outs[k] the filtering state after the k-th step."""
    ev = _iteration_view(model)
    it, emis_it, y_it = _iteration_order(model, y)
    elems = _filter_elements(*ev, emis_it, y_it, model.trans.x0)
    _, b, C, _, _ = _associative_scan(_combine_filter, elems)
    return Gaussian(b, C), ev, it, emis_it, y_it


def _batched_predict(x: Gaussian, F, c, Q) -> Gaussian:
    return Gaussian(_mv(F, x.mean) + c, symmetrize(F @ symmetrize(x.cov) @ _mT(F) + Q))


def _logpdf_from_prefix(outs, ev, emis_it, y_it):
    """The lml: each step's prediction from the prefix before it, then its
    update's lml, summed."""
    pre = _batched_predict(Gaussian(outs.mean[:-1], outs.cov[:-1]), *ev)
    return em.step_posterior_and_lml(pre, emis_it, y_it)[1].sum()


def widened(model):
    """The model with every leaf in float64, a Fill still a Fill: the
    float32 model's problem as float32 stores it, solved in float64."""
    wide = lambda leaf: (Fill(leaf.value.double(), leaf.N) if is_fill(leaf) else leaf.double())
    t = model.trans
    trans = GaussMarkov(As=wide(t.As), offs=wide(t.offs), Qs=wide(t.Qs),
                        x0=Gaussian(t.x0.mean.double(), t.x0.cov.double()), forward=t.forward)
    return LGSSM(trans, em.map_leaves(wide, model.emis))


def posterior_filter_model(model, y):
    """(model, y) as the posterior's filter takes them: a float32 model's
    widened to float64 (`widened`). The reversal factors each step's
    prediction F P F^T + Q; a float32 filter's covariances at D = 375 (the
    parallel scan) or 600 (the block matrix path) are indefinite beyond
    POSTERIOR_JITTER (a space-time model's, whose Q = Kr (x) Q_t has
    eigenvalues far below float32's resolution of its largest), so the
    filter that feeds it runs in float64, as the reversal itself does."""
    if model.dtype != torch.float32:
        return model, y
    return widened(model), y.double()


def _reversed_model_matrix(model, xf: Gaussian, jitter=POSTERIOR_JITTER):
    """(posterior, predictions): the reverse-ordered posterior LGSSM of a
    forward-ordered model from its stacked filtering states, and the
    predicted state of every step (float64) that it inverts the dynamics
    against (`models.lgssm._invert_dynamics`, `jitter` on each predicted
    covariance; the Fisher gradient's exact smoother passes 0), batched over
    the N steps, in float64 whatever the model's dtype, then stored in it
    (Q_rev is a difference of nearly equal covariances, which float32 cannot
    form)."""
    t, x0 = model.trans, model.trans.x0
    wide = lambda x: x.to(torch.float64)
    prev = Gaussian(wide(torch.cat([x0.mean[None].to(xf.mean), xf.mean[:-1]])),
                    wide(torch.cat([symmetrize(x0.cov)[None].to(xf.cov), xf.cov[:-1]])))
    F, c, Q = (wide(tmaterialize(leaf)) for leaf in (t.As, t.offs, t.Qs))
    xp = _batched_predict(prev, F, c, Q)
    A_rev, a_rev, Q_rev = (x.to(model.dtype) for x in _invert_dynamics(prev, xp, F, jitter))
    trans = GaussMarkov(As=A_rev, offs=a_rev, Qs=Q_rev, forward=False,
                        x0=Gaussian(xf.mean[-1].to(model.dtype), xf.cov[-1].to(model.dtype)))
    return LGSSM(trans, model.emis), xp


def _posterior_from_prefix(model, outs, it):
    """The smoother as an LGSSM of the opposite ordering from the filtering
    prefixes (the reference's `assoc.posterior` post-processing). A forward
    model's dynamics are inverted between each state before a step and its
    prediction; a reverse model's between each post-update state's
    prediction and that state, the last prediction its x0. Inverted in
    float64, as `_reversed_model_matrix`."""
    if model.trans.forward:
        return _reversed_model_matrix(model, Gaussian(outs.mean[1:], outs.cov[1:]))[0]
    wide = lambda x: x.to(torch.float64)
    u = Gaussian(wide(outs.mean[1:]), wide(outs.cov[1:]))
    F, c, Q = (wide(x) for x in it)
    xp = _batched_predict(u, F, c, Q)
    A_rev, a_rev, Q_rev = (x.to(model.dtype) for x in _flip(_invert_dynamics(xp, u, F)))
    trans = GaussMarkov(As=A_rev, offs=a_rev, Qs=Q_rev,
                        x0=Gaussian(xp.mean[-1].to(model.dtype), xp.cov[-1].to(model.dtype)),
                        forward=True)
    return LGSSM(trans, model.emis)


# ---------------------------------------------------------------------------
# Engine entry points (the semantics of models.lgssm's sequential engine)
# ---------------------------------------------------------------------------

def filter_(model, y) -> Gaussian:
    """Filtering distributions at every step, in time order."""
    outs = _filter_prefix(model, y)[0]
    return _unflip(model, Gaussian(outs.mean[1:], outs.cov[1:]))


def logpdf(model, y):
    """Log marginal likelihood, either ordering."""
    outs, ev, _, emis_it, y_it = _filter_prefix(model, y)
    return _logpdf_from_prefix(outs, ev, emis_it, y_it)


def posterior(model, y):
    """The smoother as a reverse-ordered (for a reverse model, forward-
    ordered) LGSSM: the prefix filter (in float64 for a float32 model,
    `posterior_filter_model`), then the batched inversion of the
    dynamics."""
    outs, _, it, _, _ = _filter_prefix(*posterior_filter_model(model, y))
    return _posterior_from_prefix(model, outs, it)


def latent_marginals(model) -> Gaussian:
    """Marginals of the latent chain: the prefix of the affine maps of the
    iteration view from the prior's, in time order. The identity the view
    puts first encodes a reverse model's emit-before-transition order, so
    the prefixes 1..N serve both orderings."""
    F, c, Q = _iteration_view(model)
    D = model.latent_dim
    prior = _prior_element(model.trans.x0, D, F)[:3]
    elems = tuple(torch.cat([p, e]) for p, e in zip(prior, (F, c, Q)))
    _, b, C = _associative_scan(_combine_affine, elems)
    return _unflip(model, Gaussian(b[1:], C[1:]))


def marginals_diag(model):
    """(means, variance diagonals) of the observations: for scalar ones
    (H m + h, H P H^T + s)."""
    return em.step_predict_marginals(latent_marginals(model),
                                     em.map_leaves(tmaterialize, model.emis))


def rand_with_eps(model, eps_t, eps_e, x_init):
    """The joint sample of the observations that the standard normals eps_t
    (N, D), eps_e ((N,) or (N, Dout)) and the initial state x_init give: the
    prefix of the sample's affine maps (`_sample_maps`) from x_init, then
    each step's observation given its state (for scalar emissions y = H x +
    h + sqrt(s) eps_e)."""
    F, b = _sample_maps(model, eps_t)
    prior = (F.new_zeros(1, *F.shape[1:]), x_init[None].to(F))
    _, states = _associative_scan(_combine_affine_mean,
                                  tuple(torch.cat([p, e]) for p, e in zip(prior, (F, b))))
    _, emis_it, eps_it = _iteration_order(model, eps_e)
    return _unflip(model, em.step_conditional_rand(eps_it, states[1:], emis_it))
