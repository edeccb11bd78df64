"""The port's time-invariant engines, engine="lti" (temporalgps_torch/ops/
lti.py) and "steady" (ops/steady.py), against the reference's
(temporalgps_tpu/ops/lti.py, steady.py), on the CPU in float64, with the
contracts of tests/test_steady_engine.py and tests/test_lti_engine.py at
their sizes.

The reference's calls run under jax.jit; its steady and lti gradients take
~13 s each to compile, so the port's gradients are held to the reference's
sequential engine's (jax.grad), the steady engine's values to the
reference's steady engine on the same inputs. Tolerances: 1e-10 (values,
marginals, samples), gradients 1e-8 of the largest component; on the
space-time models the reference's own steady tests' against its sequential
engine (a grid's lml 1e-8; the pseudo-point model's 1e-9, its gradient
1e-6). Both packages shrink the default warmup to 128 (the reference
test's fixture), so N = 448 exercises the steady segment.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.space_time as jst
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import EQ as JEQ
from temporalgps_tpu.gp import GP as JGP
from temporalgps_tpu.gp import ConstMean as JConstMean
from temporalgps_tpu.gp import Matern52 as JMatern52
from temporalgps_tpu.gp import to_sde as jto_sde
from temporalgps_tpu.gp.lti_sde import build_lgssm as jbuild
from temporalgps_tpu.models import lgssm as jlg
from temporalgps_tpu.ops import lti as jlti
from temporalgps_tpu.ops import steady as jsteady

import temporalgps_torch as tt
from temporalgps_torch.gp import EQ, GP, ArrayStorage, ConstMean, Matern52, to_sde
from temporalgps_torch.gp.lti_sde import build_lgssm
from temporalgps_torch.gp.lti_sde import logpdf as gp_logpdf
from temporalgps_torch.models import lgssm as tlg
from temporalgps_torch.models.lgssm import LGSSM
from temporalgps_torch.ops import lti, steady
from temporalgps_torch.ops.steady import affine_const_states, affine_const_states_multi

torch.set_num_threads(1)

N, DT, WARMUP = 448, 0.1, 128
RNG = np.random.default_rng(16)
Y = RNG.standard_normal(N)
P0 = np.array([0.1, -0.2, -2.0])
NS, NT, M = 5, 320, 3  # the pseudo-point model of tests/test_steady_engine.py


@pytest.fixture(autouse=True)
def short_warmup(monkeypatch):
    monkeypatch.setattr(steady, "DEFAULT_WARMUP", WARMUP)
    monkeypatch.setattr(jsteady, "DEFAULT_WARMUP", WARMUP)


def _close(actual, desired, rtol):
    desired = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64), desired, rtol=0,
                               atol=rtol * np.abs(desired).max())


def _models(n=N, mean=None):
    """(reference, port) LGSSM of Matern52 on RegularSpacing(0, DT, n), noise
    0.1, an optional ConstMean."""
    jgp = JGP(JMatern52()) if mean is None else JGP(JMatern52(), JConstMean(mean))
    tgp = GP(Matern52()) if mean is None else GP(Matern52(), ConstMean(mean))
    return (jbuild(jto_sde(jgp)(JRegularSpacing(0.0, DT, n), 0.1)),
            build_lgssm(to_sde(tgp, device="cpu")(tt.RegularSpacing(0.0, DT, n), 0.1)))


def test_affine_const_states_against_the_loop_and_its_backward():
    """The blocked schedule against the plain loop (a padded last block), the
    (D, R) form against R columns, and the Function's adjoint against
    autograd through its forward schedule."""
    rng = np.random.default_rng(1)
    D, n = 5, 237
    G = torch.as_tensor(rng.standard_normal((D, D)) * 0.3)
    w, m0 = torch.as_tensor(rng.standard_normal((n, D))), torch.as_tensor(rng.standard_normal(D))
    m, want = m0, []
    for t in range(n):
        m = G @ m + w[t]
        want.append(m)
    _close(affine_const_states(G, w, m0), torch.stack(want), 1e-12)
    _close(affine_const_states(G, w, m0),
           jsteady.affine_const_states(*(jnp.asarray(a.numpy()) for a in (G, w, m0))), 1e-12)
    W, M0 = torch.as_tensor(rng.standard_normal((97, 4, 6))), torch.as_tensor(
        rng.standard_normal((4, 6)))
    G4 = G[:4, :4]
    cols = torch.stack([affine_const_states(G4, W[:, :, r], M0[:, r], block_len=5)
                        for r in range(6)], dim=-1)
    _close(affine_const_states_multi(G4, W, M0, block_len=5), cols, 1e-12)
    bar = torch.as_tensor(rng.standard_normal((n, D)))
    grads = []
    for fn in (affine_const_states, lambda *a: steady._acs_impl(*a, 16)):
        args = [a.clone().requires_grad_(True) for a in (G, w, m0)]
        grads.append(torch.autograd.grad((fn(*args) * bar).sum(), args))
    for got, want in zip(*grads):
        _close(got, want, 1e-10)


@functools.lru_cache(maxsize=None)
def _reference_lml_and_grad():
    x, y = JRegularSpacing(0.0, DT, N), jnp.asarray(Y)

    def loss(p):
        s2, sc, noise = jnp.exp(p)
        return jlg.logpdf(jbuild(jto_sde(JGP((s2 * JMatern52()).stretch(sc)))(x, noise)), y,
                          engine="sequential")

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(P0))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("engine", ["steady", "lti"])
def test_scalar_logpdf_and_gradient_match_reference(engine):
    """The lml and its autograd gradient (the Function's adjoint on steady)
    against the reference's sequential engine; steady's value also against
    the reference's steady engine."""
    value, grad = _reference_lml_and_grad()
    p = torch.tensor(P0, requires_grad=True)
    s2, sc, noise = torch.exp(p)
    fx = to_sde(GP((s2 * Matern52()).stretch(sc)), device="cpu")(tt.RegularSpacing(0.0, DT, N),
                                                                 noise)
    lp = tlg.logpdf(build_lgssm(fx), torch.as_tensor(Y), engine=engine)
    _close(lp.item(), value, 1e-10)
    _close(torch.autograd.grad(lp, p)[0], grad, 1e-8)
    if engine == "steady":
        jm, tm = _models()
        want = jax.jit(lambda: jlg.logpdf(jm, jnp.asarray(Y), engine="steady"))()
        _close(tlg.logpdf(tm, torch.as_tensor(Y), engine="steady").item(), float(want), 1e-12)


def test_prior_marginals_and_rand_match_reference():
    """marginals_diag and latent_marginals (exact head, converged tail) and
    rand_with_eps (exact) against the reference's steady engine on the same
    normals; lti's marginals too."""
    jm, tm = _models()
    for got, want in zip(tlg.marginals_diag(tm, engine="steady"),
                         jax.jit(lambda: jlg.marginals_diag(jm, engine="steady"))()):
        _close(got, want, 1e-12)
    for got, want in zip(tlg.marginals_diag(tm, engine="lti"),
                         jax.jit(lambda: jlg.marginals_diag(jm, engine="lti"))()):
        _close(got, want, 1e-12)
    got = tlg.latent_marginals(tm, engine="steady")
    want = jax.jit(lambda: jlg.latent_marginals(jm, engine="steady"))()
    _close(got.mean, want.mean, 1e-12)
    _close(got.cov, want.cov, 1e-12)
    rng = np.random.default_rng(2)
    eps_t, eps_e, x0 = rng.standard_normal((N, 3)), rng.standard_normal(N), rng.standard_normal(3)
    want = jax.jit(jsteady.rand_with_eps)(jm, *(jnp.asarray(a) for a in (eps_t, eps_e, x0)))
    got = tlg.rand_with_eps(tm, *(torch.as_tensor(a) for a in (eps_t, eps_e, x0)),
                            engine="steady")
    _close(got, want, 1e-10)
    _close(got, tlg.rand_with_eps(tm, *(torch.as_tensor(a) for a in (eps_t, eps_e, x0)),
                                  engine="sequential"), 1e-10)


@pytest.mark.parametrize("n, n_warmup", [(N, WARMUP), (100, 256)])
def test_posterior_marginals_diag_matches_reference(n, n_warmup):
    """The steady smoother (exact head, constant middle, tail), and below
    2 n_warmup its delegation to the lti smoother, against the reference's
    steady engine and the port's sequential smoother."""
    jm, tm = _models(n)
    y = Y[:n]
    want = jax.jit(lambda yy: jsteady.posterior_marginals_diag(jm, yy, n_warmup=n_warmup))(
        jnp.asarray(y))
    got = steady.posterior_marginals_diag(tm, torch.as_tensor(y), n_warmup=n_warmup)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
    post = tlg.posterior(tm, torch.as_tensor(y), engine="sequential")
    for g, s in zip(got, tlg.marginals_diag(LGSSM(post.trans, tm.emis), engine="sequential")):
        _close(g, s, 1e-8)


def test_delegation_to_lti_and_the_warmup():
    """With n_warmup >= N steady is lti's lml, exactly; n_warmup reaches it
    from the drivers; suggest_warmup is the reference's."""
    jm, tm = _models(300)
    y = torch.as_tensor(Y[:300])
    assert steady.logpdf(tm, y, n_warmup=512).item() == lti.logpdf(tm, y).item()
    _, tm = _models()
    y = torch.as_tensor(Y)
    _close(tlg.logpdf(tm, y, engine="steady", n_warmup=96).item(),
           tlg.logpdf(tm, y, engine="steady").item(), 1e-10)
    jm, _ = _models()
    assert steady.suggest_warmup(tm) == jsteady.suggest_warmup(jm)
    assert 64 <= steady.suggest_warmup(tm) < 512


def test_nonzero_mean_and_vector_emissions_match_reference():
    """A ConstMean on the scalar model (the offset enters the gain's
    constant once; against the reference's steady engine) and on a grid's
    DenseEmissions model (D = 15: steady and lti against the reference's
    sequential engine at its own steady test's 1e-8)."""
    jm, tm = _models(mean=1.5)
    y = Y + 1.5
    want = float(jax.jit(lambda: jlg.logpdf(jm, jnp.asarray(y), engine="steady"))())
    _close(tlg.logpdf(tm, torch.as_tensor(y), engine="steady").item(), want, 1e-12)
    ns, nt = 5, 256
    xl = np.linspace(-2, 2, ns)
    jfx = jto_sde(JGP(jst.Separable(JEQ(), JMatern52()), JConstMean(0.7)))(
        jst.RectilinearGrid(jnp.asarray(xl), JRegularSpacing(0.0, 0.05, nt)), 0.25)
    tfx = to_sde(GP(tt.Separable(EQ(), Matern52()), ConstMean(0.7)), device="cpu")(
        tt.RectilinearGrid(torch.as_tensor(xl), tt.RegularSpacing(0.0, 0.05, nt)), 0.25)
    y2 = RNG.standard_normal((nt, ns)) + 0.7
    want = float(jax.jit(lambda: jlg.logpdf(jbuild(jfx), jnp.asarray(y2), engine="sequential"))())
    model = build_lgssm(tfx)
    for engine in ("steady", "lti"):
        _close(tlg.logpdf(model, torch.as_tensor(y2), engine=engine).item(), want, 1e-8)


def _dtc_fx(pkg, p):
    s2, sc, noise = (jnp if pkg == "jax" else torch).exp(p)
    if pkg == "jax":
        x = jst.RectilinearGrid(jnp.linspace(-3.0, 3.0, NS), JRegularSpacing(0.0, 0.05, NT))
        return jto_sde(JGP(s2 * jst.Separable(JEQ().stretch(sc), JMatern52())))(x, noise)
    x = tt.RectilinearGrid(torch.linspace(-3.0, 3.0, NS, dtype=torch.float64),
                           tt.RegularSpacing(0.0, 0.05, NT))
    return to_sde(GP(s2 * tt.Separable(EQ().stretch(sc), Matern52())), device="cpu")(x, noise)


def test_dtc_elbo_gradient_and_approx_posterior_on_steady():
    """The pseudo-point model (BottleneckEmissions) on steady: elbo and its
    autograd gradient against the reference's sequential engine (its own
    steady test's 1e-9 and 1e-6), approx_posterior_marginals against it too
    (its 1e-8 and 5e-8)."""
    y = np.random.default_rng(3).standard_normal(NS * NT)
    z = np.linspace(-3.0, 3.0, M)
    value, grad = jax.jit(jax.value_and_grad(lambda p: jst.elbo(
        _dtc_fx("jax", p), jnp.asarray(y), jnp.asarray(z), engine="sequential")))(
        jnp.asarray(P0))
    p = torch.tensor(P0, requires_grad=True)
    got = tt.elbo(_dtc_fx("torch", p), y, torch.as_tensor(z), engine="steady")
    _close(got.item(), float(value), 1e-9)
    _close(torch.autograd.grad(got, p)[0], grad, 1e-6)
    xl_new = np.linspace(-2.0, 2.0, 4)
    want = jax.jit(lambda pp: jst.approx_posterior_marginals(
        _dtc_fx("jax", pp), jnp.asarray(y), jnp.asarray(z), jnp.asarray(xl_new),
        engine="sequential"))(jnp.asarray(P0))
    got = tt.approx_posterior_marginals(_dtc_fx("torch", torch.tensor(P0)), y, torch.as_tensor(z),
                                        torch.as_tensor(xl_new), engine="steady")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=5e-8)


def test_lti_posterior_matches_reference():
    """lti's posterior LGSSM (every step's dynamics inverted at once) and
    its marginals against the reference's lti engine."""
    jm, tm = _models(96)
    y = Y[:96]
    jp = jax.jit(lambda yy: jlti.posterior(jm, yy))(jnp.asarray(y))
    tp = tlg.posterior(tm, torch.as_tensor(y), engine="lti")
    for name in ("As", "offs", "Qs"):
        _close(getattr(tp.trans, name), getattr(jp.trans, name), 1e-10)
    _close(tp.trans.x0.cov, jp.trans.x0.cov, 1e-10)


def test_refusals_and_the_float32_lti_warning():
    """Per-step (irregular) models raise ValueError naming all-Fill; a NaN
    raises through the gp verbs (no missing-data fill on these engines);
    steady has no posterior LGSSM; float32 lti warns, as the reference."""
    times = torch.as_tensor(np.cumsum(0.05 + 0.05 * RNG.random(200)))
    irregular = build_lgssm(to_sde(GP(Matern52()), device="cpu")(times, 0.1))
    for engine in ("steady", "lti"):
        with pytest.raises(ValueError, match="all-Fill"):
            tlg.logpdf(irregular, torch.zeros(200, dtype=torch.float64), engine=engine)
    fx = to_sde(GP(Matern52()), device="cpu")(tt.RegularSpacing(0.0, DT, 200), 0.1)
    y = Y[:200].copy()
    y[7] = np.nan
    with pytest.raises(ValueError, match="fully-observed"):
        gp_logpdf(fx, y, engine="steady", nan_fallback=False)
    with pytest.raises(ValueError, match="posterior_marginals_diag"):
        tlg.posterior(build_lgssm(fx), torch.zeros(200, dtype=torch.float64), engine="steady")
    fx32 = to_sde(GP(Matern52()), ArrayStorage(torch.float32), device="cpu")(
        tt.RegularSpacing(0.0, DT, 200), 0.1)
    with pytest.warns(UserWarning, match="untrustworthy"):
        gp_logpdf(fx32, Y[:200], engine="lti")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gp_logpdf(fx32, Y[:200], engine="steady")


def test_float32_steady_gradient_against_float64():
    """float32 steady gradients within 2e-3 of float64's (the reference's
    contract): the constant operators in float64, the warmup's covariance
    pass "full" at D = 3."""
    def grad(dtype):
        x = tt.RegularSpacing(torch.tensor(0.0, dtype=dtype), torch.tensor(0.01, dtype=dtype), 1024)
        p = torch.tensor([0.1, -0.2, -2.0], dtype=dtype, requires_grad=True)
        s2, sc, noise = torch.exp(p)
        fx = to_sde(GP((s2 * Matern52()).stretch(sc)), ArrayStorage(dtype), device="cpu")(x, noise)
        y = torch.as_tensor(np.random.default_rng(4).standard_normal(1024), dtype=dtype)
        return torch.autograd.grad(tlg.logpdf(build_lgssm(fx), y, engine="steady"), p)[0].double()

    g64, g32 = grad(torch.float64), grad(torch.float32)
    assert ((g32 - g64).abs() / (g64.abs() + 1e-6)).max().item() < 2e-3
