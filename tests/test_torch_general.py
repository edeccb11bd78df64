"""The port's general block schedule (temporalgps_torch/ops/block.py: the lane
path and the streamed kernels' plain versions for per-step transitions with
D <= 3, the matrix path for D > 3) against the reference's
(temporalgps_tpu/ops/block.py `_logpdf_xla`, `filter_`, `posterior`,
`affine_prefix_states`), on the CPU in float64.

Inputs come from numpy and go through both packages: N = 37 irregular times
cut into B = 4 blocks (three padding steps), one NaN, per-point noise. The
D = 3 model is a Matern-5/2; the D = 6 model a sum of two Matern-5/2s, built
by the reference and carried across as numpy (the schedule held apart from the
kernel compiler, which tests/test_torch_composite.py holds).
Tolerances: 1e-10 relative for the lml, filtering states, posterior leaves
and latent marginals (the same algebra in the same association); 1e-9 for
posterior marginals at new times; 1e-8 for gradients (two autodiff systems
through the same recursions).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import learning as jlearning
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.gp import posterior as jpost
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock

import temporalgps_torch as tt
from temporalgps_torch import convert
from temporalgps_torch.gp import GP, Matern52, build_lgssm, to_sde
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.ops import block, kernels

torch.set_num_threads(1)

N, NAN_AT, B = 37, 11, 4
TIMES = np.cumsum(np.random.default_rng(0).uniform(0.05, 0.15, N))
NOISE = np.random.default_rng(2).uniform(0.1, 0.3, N)
P0 = np.array([0.3, -0.2, -0.5])  # log sigma^2, log stretch, log noise
JAX_KERNELS = {
    3: lambda: (1.3 * jgp.Matern52()).stretch(0.7),
    6: lambda: jgp.Matern52() + jgp.Matern52().stretch(3.0),
}


def _y(seed=1):
    y = np.random.default_rng(seed).standard_normal(N)
    y[NAN_AT] = np.nan
    return y


def _close(actual, desired, rtol=1e-10):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=rtol * np.abs(desired).max())


def _carry(jmodel, forward=True):
    """A reference LGSSM as a port LGSSM on the CPU, leaf by leaf."""
    t, e = jmodel.trans, jmodel.emis
    val = lambda leaf: np.asarray(getattr(leaf, "value", leaf))
    return convert.lgssm_from_numpy(
        *(val(leaf) for leaf in (t.As, t.offs, t.Qs, e.H, e.h, e.s)),
        np.asarray(t.x0.mean), np.asarray(t.x0.cov), N, dtype=torch.float64, device="cpu",
        forward=forward)


@functools.cache
def _models(D):
    """(reference model with the NaN filled, its y, port model, port y) for
    the D-state model on the irregular times."""
    fx = jgp.to_sde(jgp.GP(JAX_KERNELS[D]()))(jnp.asarray(TIMES), jnp.asarray(NOISE))
    jmodel, jy, _ = jmissings.transform_model_and_obs(japi.build_lgssm(fx), jnp.asarray(_y()))
    return jmodel, jy, _carry(jmodel), torch.as_tensor(np.asarray(jy))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("D", [3, 6], ids=["lanes", "matrix"])
def test_logpdf_matches_reference_general_schedule(D, fused):
    """D = 3: the lane path (fused=False) and the autograd Function over the
    streamed wrappers, whose plain versions run here (fused=True); D = 6:
    the matrix path either way."""
    jmodel, jy, tmodel, ty = _models(D)
    assert not block._pallas_supported(tmodel)
    assert block._streamed_supported(tmodel) == (D == 3)
    ref = float(jax.jit(jblock._logpdf_xla, static_argnums=2)(jmodel, jy, B))
    got = tlgssm.logpdf(tmodel, ty, engine="block", n_blocks=B, fused=fused).item()
    np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("D", [3, 6], ids=["lanes", "matrix"])
def test_filter_posterior_and_marginals_match_reference(D):
    """filter_, the posterior's reversed leaves, and the latent and
    observation marginals of that posterior (K8-K10's plain versions for
    D = 3, the matrix affine prefix for D = 6). D = 3 against the
    reference's block engine; D = 6 against its sequential engine, because
    the port's matrix path inverts without the jitter that the reference's
    adds to each combine (which moves it ~2e-8 from the sequential value
    here)."""
    jmodel, jy, tmodel, ty = _models(D)
    ref = (functools.partial(jblock.filter_, n_blocks=B),
           functools.partial(jblock.posterior, n_blocks=B),
           functools.partial(jblock.latent_marginals, n_blocks=B))
    if D > 3:
        ref = tuple(functools.partial(fn, engine="sequential")
                    for fn in (jlgssm.filter_, jlgssm.posterior, jlgssm.latent_marginals))
    xf_ref = jax.jit(ref[0])(jmodel, jy)
    xf = tlgssm.filter_(tmodel, ty, engine="block", n_blocks=B)
    _close(xf.mean, xf_ref.mean)
    _close(xf.cov, xf_ref.cov)
    post_ref = jax.jit(ref[1])(jmodel, jy)
    post = tlgssm.posterior(tmodel, ty, engine="block", n_blocks=B)
    assert not post.trans.forward
    for got, want in ((post.trans.As, post_ref.trans.As), (post.trans.offs, post_ref.trans.offs),
                      (post.trans.Qs, post_ref.trans.Qs), (post.trans.x0.mean, post_ref.trans.x0.mean),
                      (post.trans.x0.cov, post_ref.trans.x0.cov)):
        _close(got, want)
    lat_ref = jax.jit(ref[2])(post_ref)
    lat = tlgssm.latent_marginals(post, engine="block", n_blocks=B)
    _close(lat.mean, lat_ref.mean)
    _close(lat.cov, lat_ref.cov)
    m, v = tlgssm.marginals_diag(post, engine="block", n_blocks=B)
    m_seq, v_seq = tlgssm.marginals_diag(post, engine="sequential")
    _close(m, m_seq)
    _close(v, v_seq)


def test_matrix_affine_prefix_states_matches_reference():
    """The matrix branch of affine_prefix_states at D = 6: the prior chain's
    transitions of the D = 6 model, from its x0."""
    tmodel = _models(6)[2]
    F, c, Q = block._iteration_view(tmodel)
    x0 = tmodel.trans.x0
    ref = jblock.affine_prefix_states(*(jnp.asarray(t.numpy()) for t in (F, c, Q, x0.mean, x0.cov)),
                                      n_blocks=B)
    got = block.affine_prefix_states(F, c, Q, x0.mean, x0.cov, n_blocks=B)
    _close(got.mean, ref.mean)
    _close(got.cov, ref.cov)


def test_posterior_marginals_at_new_times_match_reference():
    """New times merged with the irregular training times: the merged
    model's filter on the lane path, its marginals on K8-K10's plain
    versions."""
    x_pr = np.sort(np.random.default_rng(4).uniform(TIMES[0] - 0.2, TIMES[-1] + 0.2, 13))
    y = _y()
    jf = jgp.to_sde(jgp.GP(JAX_KERNELS[3]()))(jnp.asarray(TIMES), jnp.asarray(NOISE))
    m_ref, v_ref = jpost.marginals(jpost.posterior(jf, jnp.asarray(y))(jnp.asarray(x_pr), 0.05))
    tf = to_sde(GP((1.3 * Matern52()).stretch(0.7)), device="cpu")(
        torch.as_tensor(TIMES), torch.as_tensor(NOISE))
    fxp = tpost.posterior(tf, y)(x_pr, 0.05)
    m, v = tpost.marginals(fxp, engine="block")
    _close(m, m_ref, rtol=1e-9)
    _close(v, v_ref, rtol=1e-9)


def _jax_model_fn(p):
    s2, sc, noise = jnp.exp(p)
    fx = jgp.to_sde(jgp.GP((s2 * jgp.Matern52()).stretch(sc)))(jnp.asarray(TIMES), noise)
    return japi.build_lgssm(fx)


def _torch_model_fn(p):
    s2, sc, noise = torch.exp(p)
    return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)), device="cpu")(
        torch.as_tensor(TIMES), noise))


def test_value_and_grad_fwd_lgssm_on_irregular_times_matches_reference():
    """Per-step transitions: not K4-K6's, so both packages take the
    forward-mode gradient of their general block schedule."""
    y = _y()
    v_ref, g_ref = jax.jit(jlearning.value_and_grad_fwd_lgssm(_jax_model_fn, jnp.asarray(y),
                                                              n_blocks=B))(jnp.asarray(P0))
    v, g = tt.value_and_grad_fwd_lgssm(_torch_model_fn, y, n_blocks=B)(torch.from_numpy(P0))
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=1e-8)
    _close(g, g_ref, rtol=1e-8)


def test_reverse_mode_gradient_of_the_streamed_function_matches_reference():
    """torch.autograd through the Function over the streamed wrappers
    (forward: their plain versions here; backward: the lane path) against
    jax.grad of `_logpdf_xla`."""
    y = _y()

    def jax_lml(p):
        model, yf, comp = jmissings.transform_model_and_obs(_jax_model_fn(p), jnp.asarray(y))
        return jblock._logpdf_xla(model, yf, B) + comp

    lml_ref, g_ref = jax.jit(jax.value_and_grad(jax_lml))(jnp.asarray(P0))
    p = torch.from_numpy(P0).requires_grad_()
    lml = tmissings.logpdf_with_missings(_torch_model_fn(p), torch.as_tensor(y), engine="block",
                                         n_blocks=B, fused=True)
    (g,) = torch.autograd.grad(lml, p)
    np.testing.assert_allclose(lml.item(), float(lml_ref), rtol=1e-10)
    _close(g, g_ref, rtol=1e-8)


@pytest.mark.parametrize("L,Bs", [(37, 5), (3, 2)], ids=["L37_B5", "L3_B2"])
def test_streamed_plain_versions_chunked_match_the_lane_path(L, Bs):
    """K1's, K3's and K7's streamed plain versions on their kernels' chunk
    schedules against the same functions run serially (the lane path), at
    ragged (L, B): L not a multiple of the chunk count or below it, a
    missing step, padding steps with identity rows."""
    rng = np.random.default_rng(L)
    D = 3
    model = _models(3)[2]
    # Each step a transition of the irregular model, drawn at random.
    pick = rng.integers(0, N, (L, Bs))
    F, Qm = model.trans.As.numpy()[pick], model.trans.Qs.numpy()[pick]
    rows = np.concatenate([F.reshape(L, Bs, 9), 0.01 * rng.standard_normal((L, Bs, 3)),
                           Qm.reshape(L, Bs, 9)], axis=-1).transpose(2, 0, 1)
    s = np.full((L, Bs), 0.2)
    s[min(2, L - 1), 0] = 1e15
    s[L - 1, Bs - 1] = 1e15
    rows[:, L - 1, Bs - 1] = np.concatenate([np.eye(3).ravel(), np.zeros(12)])
    y = torch.as_tensor(rng.standard_normal((L, Bs)))
    s, rows = torch.as_tensor(s), torch.as_tensor(np.ascontiguousarray(rows))
    H = model.emis.H.value
    packed = block._emission_params(H, model.emis.h.value, torch.float64)
    m0, P0_ = model.trans.x0.mean, model.trans.x0.cov
    C = kernels.PHASE1_AGGREGATE_CHUNKS
    agg, runs = kernels.phase1_aggregate_plain(y, s, packed, D, chunks=C, trans_rows=rows)
    agg1, runs1 = kernels.phase1_aggregate_plain(y, s, packed, D, trans_rows=rows)
    assert runs.shape == (C, kernels.elem_rows(D), Bs) and runs1.shape[0] == 1
    _close(agg, agg1)
    starts = kernels.phase2_starts_plain(agg1, m0, P0_, D)
    lml = kernels.phase3_lml_plain(y, s, packed, starts, D, runs, trans_rows=rows)
    _close(lml, kernels.phase3_lml_plain(y, s, packed, starts, D, trans_rows=rows))
    st = kernels.phase3_states_plain(y, s, packed, starts, D, chunks=kernels.PHASE3_STATES_CHUNKS,
                                     trans_rows=rows)
    _close(st, kernels.phase3_states_plain(y, s, packed, starts, D, trans_rows=rows))
    # The wrappers on CPU tensors run the serial plain versions, and count nothing.
    kernels.reset_launch_counts()
    pair = kernels.phase1_aggregate_streamed(y, s, packed, D, rows)
    _close(pair[0], agg1)
    _close(kernels.phase3_lml_streamed(y, s, packed, starts, D, runs1, rows), lml)
    _close(kernels.phase3_states_streamed(y, s, packed, starts, D, rows), st)
    assert all(n == 0 for n in kernels.launch_counts().values())
