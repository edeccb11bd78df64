"""The port's smoothing and posterior prediction (temporalgps_torch:
models.lgssm.posterior, marginals_diag, latent_marginals, gp.posterior)
against the reference package on the CPU, float64.

The reference runs its sequential engine and its XLA block schedules, never
interpret-mode Pallas. Tolerances: marginals within 1e-9 (rtol, with an
absolute floor of 1e-9 of the largest entry); the posterior's reversed
dynamics within 1e-10. The port's block engine inverts the predicted
covariance with the adjugate where the reference's sequential engine uses a
Cholesky solve: two roundings of the same inverse, which differ by at most
~3e-15 of the largest entry at these sizes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.gp import posterior as jpost
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings

import temporalgps_torch as tt
from temporalgps_torch import convert
from temporalgps_torch.gp import GP, ArrayStorage, ConstMean, Matern12, Matern32, Matern52
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.gp import to_sde
from temporalgps_torch.gp.lti_sde import build_lgssm
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.space_time import regular_in_time

torch.set_num_threads(1)

KERNEL_OF_DIM = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
TORCH_KERNEL = {"Matern12": Matern12, "Matern32": Matern32, "Matern52": Matern52}
N, NAN_AT, B = 21, 6, 4  # 4 blocks of 6 steps: three padding steps, one missing value

_posterior_ref = jax.jit(functools.partial(jmissings.posterior_with_missings, engine="sequential"))
_marginals_ref = jax.jit(functools.partial(jlgssm.marginals_diag, engine="sequential"))
_latent_ref = jax.jit(functools.partial(jlgssm.latent_marginals, engine="sequential"))


def _close(actual, desired, rtol=1e-9):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        np.asarray(actual), desired, rtol=rtol, atol=rtol * np.abs(desired).max()
    )


def _models(D, seed):
    """(reference model, port model, y with a NaN) for a Matern model of
    state dimension D on RegularSpacing, built in both packages."""
    y = np.random.default_rng(seed).standard_normal(N)
    y[NAN_AT] = np.nan
    name = KERNEL_OF_DIM[D]
    jfx = jgp.to_sde(jgp.GP((1.3 * getattr(jgp, name)()).stretch(0.7)))(
        JRegularSpacing(0.0, 0.3, N), 0.2)
    tfx = to_sde(GP((1.3 * TORCH_KERNEL[name]()).stretch(0.7)), ArrayStorage(torch.float64),
                 device="cpu")(tt.RegularSpacing(0.0, 0.3, N), 0.2)
    return jax.jit(lambda: japi.build_lgssm(jfx))(), build_lgssm(tfx), y


def _carry_posterior(post):
    """A reference posterior (reverse-ordered, per-step leaves) as a port LGSSM."""
    t, e = post.trans, post.emis
    val = lambda leaf: getattr(leaf, "value", leaf)
    return convert.lgssm_from_numpy(
        *(np.asarray(val(leaf)) for leaf in (t.As, t.offs, t.Qs, e.H, e.h, e.s)),
        np.asarray(t.x0.mean), np.asarray(t.x0.cov), N,
        dtype=torch.float64, device="cpu", forward=False)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_lgssm_posterior_matches_reference(D):
    """The port's posterior, sequential and on the blocked schedule (K1, K2,
    K7 plain), against the reference's sequential posterior: reversed
    leaves, and the marginals of the reverse chain on both port engines; the
    reference's posterior carried across gives the same marginals."""
    jmodel, tmodel, y = _models(D, seed=D)
    jpost_model = _posterior_ref(jmodel, jnp.asarray(y))
    m_ref, v_ref = _marginals_ref(jpost_model)
    y_t = torch.as_tensor(y)
    for engine in ("sequential", "block"):
        post = tmissings.posterior_with_missings(tmodel, y_t, engine=engine, n_blocks=B)
        assert not post.trans.forward
        for got, want in ((post.trans.As, jpost_model.trans.As),
                          (post.trans.offs, jpost_model.trans.offs),
                          (post.trans.Qs, jpost_model.trans.Qs),
                          (post.trans.x0.mean, jpost_model.trans.x0.mean),
                          (post.trans.x0.cov, jpost_model.trans.x0.cov)):
            _close(got, want, rtol=1e-10)
        for marg_engine in ("sequential", "block"):
            m, v = tlgssm.marginals_diag(post, engine=marg_engine, n_blocks=B)
            _close(m, m_ref)
            _close(v, v_ref)
    carried = _carry_posterior(jpost_model)
    for engine in ("sequential", "block"):
        m, v = tlgssm.marginals_diag(carried, engine=engine, n_blocks=B)
        _close(m, m_ref)
        _close(v, v_ref)


@pytest.mark.parametrize("forward", [True, False], ids=["prior", "posterior"])
def test_latent_marginals_both_orderings_match_reference(forward):
    """Latent marginals of the prior (forward) and of the reference's
    posterior carried across (reverse), sequential and on the affine block
    schedule (K8-K10 plain), against the reference's sequential engine."""
    jmodel, tmodel, y = _models(3, seed=10)
    if not forward:
        jmodel = _posterior_ref(jmodel, jnp.asarray(y))
        tmodel = _carry_posterior(jmodel)
    want = _latent_ref(jmodel)
    for engine in ("sequential", "block"):
        got = tlgssm.latent_marginals(tmodel, engine=engine, n_blocks=B)
        _close(got.mean, want.mean)
        _close(got.cov, want.cov)
        marg = tlgssm.marginals(tmodel, engine=engine, n_blocks=B)
        m, v = tlgssm.marginals_diag(tmodel, engine=engine, n_blocks=B)
        assert torch.equal(marg.mean, m) and torch.equal(marg.cov, v)


# ---------------------------------------------------------------------------
# gp.posterior, mirroring tests/test_posterior_api.py
# ---------------------------------------------------------------------------

N_TR, N_PR = 11, 7


def _gp_setup(name, seed):
    """Irregular training times with per-point noise and a NaN, a ConstMean;
    the same prior in both packages."""
    rng = np.random.default_rng(seed)
    x_tr = np.sort(rng.uniform(0.0, 5.0, N_TR))
    noise_tr = 0.1 + rng.random(N_TR)
    y = rng.standard_normal(N_TR)
    y[3] = np.nan
    x_pr = np.sort(rng.uniform(-1.0, 6.0, N_PR))
    noise_pr = 0.05 + 0.1 * rng.random(N_PR)
    jf = jgp.to_sde(jgp.GP(0.7 * getattr(jgp, name)().stretch(0.9), jgp.ConstMean(1.5)))
    tf = to_sde(GP(0.7 * TORCH_KERNEL[name]().stretch(0.9), ConstMean(1.5)), device="cpu")
    return jf, tf, x_tr, noise_tr, y, x_pr, noise_pr


def _reference_posterior_marginals(jf, x_tr, noise_tr, y, x_pr, noise_pr):
    """The reference's gp.posterior.marginals. At the training inputs it is
    jitted whole; at new inputs its host-side merge runs eagerly and the
    rest of its body (the merged model's posterior and marginals) jitted."""
    jfx = jf(x_tr, noise_tr)
    if x_pr is None:
        fn = jax.jit(lambda yy: jpost.marginals(jpost.posterior(jfx, yy)(jfx.x, noise_pr)))
        return fn(jnp.asarray(y))
    fp = jpost.posterior(jfx, jnp.asarray(y))
    fxp = fp(x_pr, noise_pr)
    x_sorted, noise_all, y_all, _, pr_idx = jpost._build_inference_data(fp, fxp.x)
    noise_pred = jpost._pred_noise_full(pr_idx, len(x_sorted), fxp.noise, jnp.float64)
    fn = jax.jit(lambda *a: jlgssm.marginals_diag(jpost._posterior_model(fp, *a)))
    m, v = fn(x_sorted, noise_all, y_all, noise_pred)
    return m[pr_idx], v[pr_idx]


@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52"])
def test_gp_posterior_marginals_match_reference(name):
    """gp.posterior.marginals at the training inputs, at new irregular
    inputs and at interleaved regular inputs; mean, var and mean_and_var
    agree with it."""
    jf, tf, x_tr, noise_tr, y, x_pr, noise_pr = _gp_setup(name, seed=len(name))
    tfp = tpost.posterior(tf(x_tr, noise_tr), y)
    cases = [
        (tfp.x, 0.2, None, 0.2),
        (x_pr, noise_pr, x_pr, noise_pr),
        (tt.RegularSpacing(0.05, 0.45, N_PR), 1e-6, JRegularSpacing(0.05, 0.45, N_PR), 1e-6),
    ]
    for t_x, t_noise, j_x, j_noise in cases:
        m, v = tpost.marginals(tfp(t_x, t_noise))
        m_ref, v_ref = _reference_posterior_marginals(jf, x_tr, noise_tr, y, j_x, j_noise)
        assert m.shape == v.shape == np.shape(m_ref)
        _close(m, m_ref)
        _close(v, v_ref)
    fxp = tfp(x_pr, noise_pr)
    m, v = tpost.mean_and_var(fxp)
    assert torch.equal(tpost.mean(fxp), m) and torch.equal(tpost.var(fxp), v)


def test_prior_marginals_match_reference():
    jf, tf, x_tr, noise_tr, *_ = _gp_setup("Matern52", seed=1)
    jfx = jf(x_tr, noise_tr)
    m_ref, v_ref = jax.jit(lambda: jgp.marginals(jfx))()
    m, v = tt.marginals(tf(x_tr, noise_tr))
    _close(m, m_ref)
    _close(v, v_ref)
    assert torch.equal(tt.mean(tf(x_tr, noise_tr)), m) and torch.equal(tt.var(tf(x_tr, noise_tr)), v)
    # The affine block schedule (K8-K10 plain) on a RegularSpacing prior.
    jmodel, tmodel, _ = _models(2, seed=2)
    m_ref, v_ref = _marginals_ref(jmodel)
    m, v = tlgssm.marginals_diag(tmodel, engine="block", n_blocks=B)
    _close(m, m_ref)
    _close(v, v_ref)


def test_posterior_covariance_is_refused():
    _, tf, x_tr, noise_tr, y, *_ = _gp_setup("Matern32", seed=2)
    with pytest.raises(NotImplementedError, match="Intentionally not implemented"):
        tpost.cov(tpost.posterior(tf(x_tr, noise_tr), y)(x_tr))


def test_routes_the_port_does_not_take_raise():
    """engine="lti" on per-step transitions raises ValueError, RegularInTime
    inputs (the pseudo-point verbs') TypeError, inputs of two dimensions
    that are no grid ValueError; per-step transitions, refused by the
    blocked filter before the general block schedule, now match the
    sequential engine there."""
    _, tf, x_tr, noise_tr, y, *_ = _gp_setup("Matern32", seed=3)
    model = build_lgssm(tf(x_tr, noise_tr))
    y_f = torch.nan_to_num(torch.as_tensor(y))
    xf, xf_seq = (tlgssm.filter_(model, y_f, engine=e) for e in ("block", "sequential"))
    _close(xf.mean, xf_seq.mean, rtol=1e-10)
    _close(xf.cov, xf_seq.cov, rtol=1e-10)
    post, post_seq = (tlgssm.posterior(model, y_f, engine=e) for e in ("block", "sequential"))
    for got, want in ((post.trans.As, post_seq.trans.As), (post.trans.offs, post_seq.trans.offs),
                      (post.trans.Qs, post_seq.trans.Qs)):
        _close(got, want, rtol=1e-10)
    with pytest.raises(ValueError, match="all-Fill"):
        tlgssm.marginals_diag(model, engine="lti")
    with pytest.raises(TypeError, match="pseudo-point"):
        tpost.posterior(tf(x_tr, noise_tr), y)(regular_in_time(np.arange(2.0),
                                                               [np.zeros(3), np.zeros(2)]))
    with pytest.raises(ValueError, match="exact inference takes"):
        tpost.posterior(tf(x_tr, noise_tr), y)(np.zeros((3, 2)))
