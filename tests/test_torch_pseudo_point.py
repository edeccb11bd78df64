"""The port's pseudo-point space-time models (temporalgps_torch/space_time/
pseudo_point.py: dtc, elbo, approx_posterior_marginals(_at), BottleneckEmissions
and the lgc bottleneck functions) against the reference's
(temporalgps_tpu/space_time/pseudo_point.py), on the CPU in float64.

Inputs come from numpy and go through both packages; the reference's calls
run under jax.jit. Every engine of the port is held to the reference's
sequential engine, the ground truth: values within 1e-10 relative (the
lti engine's power chain 1e-9: in either package its lml sits 0.4-2e-10
from the sequential one on this model, whose K_zz carries a 1e-12 jitter;
the reference's own steady test allows 1e-9), autograd gradients against
jax.grad within 1e-8 of the largest component, posterior means within 1e-8
of the largest and variances within 1e-9 of the largest. (The reference's own
block and parallel engines carry its jittered matrix inverse, ROADMAP
Queue 3's caveat, and sit up to 1.7e-8 from its sequential one on these
means; the port's within 4e-9.)
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
import temporalgps_tpu.space_time as jst
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.ops import lgc as jlgc
from temporalgps_tpu.utils import Gaussian as JGaussian

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import naive as tnaive
from temporalgps_torch.models.emissions import BottleneckEmissions
from temporalgps_torch.ops import lgc as tlgc
from temporalgps_torch.space_time import grids as tgrids
from temporalgps_torch.utils.gaussian import Gaussian

torch.set_num_threads(1)

NS, NT, M, DT, NAN_AT = 5, 48, 3, 0.05, 17
XL = np.linspace(-3.0, 3.0, NS)
Z = np.linspace(-3.0, 3.0, M)
X_NEW = np.linspace(-2.0, 2.0, 4)
P0 = np.array([0.1, -0.2, -2.0])  # log kernel variance, log inverse lengthscale, log noise
RNG = np.random.default_rng(15)
Y = RNG.standard_normal(NS * NT)
# Ragged inputs: slices of 5, 4 or 3 of the grid's points (the padding
# never observed), times cumsum(0.05 + U(0, 0.05)).
COUNTS = [NS - (t % 3) for t in range(NT)]
TIMES = np.cumsum(0.05 + 0.05 * RNG.random(NT))
VS = [XL[:c] + 0.1 * (t % 2) for t, c in enumerate(COUNTS)]
Y_R = RNG.standard_normal(sum(COUNTS))
GRID_ENGINES = ["sequential", "block", "parallel", "lti"]


def _y(nan):
    y = Y.copy()
    if nan:
        y[NAN_AT] = np.nan
    return y


def _close(actual, desired, rtol):
    desired = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rtol * np.abs(desired).max())


def _jfx(p, ragged=False):
    s2, sc, noise = jnp.exp(p)
    x = (jst.regular_in_time(TIMES, VS) if ragged
         else jst.RectilinearGrid(jnp.asarray(XL), JRegularSpacing(0.0, DT, NT)))
    return jgp.to_sde(jgp.GP(s2 * jst.Separable(jgp.EQ().stretch(sc), jgp.Matern52())))(x, noise)


def _tfx(p, ragged=False):
    s2, sc, noise = torch.exp(p)
    x = (tt.regular_in_time(TIMES, VS) if ragged
         else tt.RectilinearGrid(torch.as_tensor(XL), tt.RegularSpacing(0.0, DT, NT)))
    return tgp.to_sde(tgp.GP(s2 * tt.Separable(tgp.EQ().stretch(sc), tgp.Matern52())),
                      device="cpu")(x, noise)


@functools.lru_cache(maxsize=None)
def _reference(nan, ragged=False):
    """The reference's (elbo, its gradient in P0, dtc) on the sequential
    engine under jax.jit."""
    y = jnp.asarray(Y_R if ragged else _y(nan))
    vg = jax.jit(jax.value_and_grad(
        lambda p: jst.elbo(_jfx(p, ragged), y, jnp.asarray(Z), engine="sequential")))
    value, grad = vg(jnp.asarray(P0))
    dtc = jax.jit(lambda p: jst.dtc(_jfx(p, ragged), y, jnp.asarray(Z), engine="sequential"))(
        jnp.asarray(P0))
    return float(value), np.asarray(grad), float(dtc)


def _port(engine, y, ragged=False):
    p = torch.tensor(P0, requires_grad=True)
    value = tt.elbo(_tfx(p, ragged), y, torch.as_tensor(Z), engine=engine)
    grad, = torch.autograd.grad(value, p)
    dtc = tt.dtc(_tfx(torch.tensor(P0), ragged), y, torch.as_tensor(Z), engine=engine)
    return value.item(), grad.numpy(), dtc.item()


@pytest.mark.parametrize("engine", GRID_ENGINES)
def test_dtc_and_elbo_on_a_grid_match_reference(engine):
    """elbo, its autograd gradient (against jax.grad) and dtc on a grid:
    with a NaN on every engine that takes missing data, without on "lti";
    "block" with its default 32 blocks, which do not divide 48 steps (the
    padded tail)."""
    nan = engine != "lti"
    rtol = 1e-9 if engine == "lti" else 1e-10
    value, grad, dtc = _reference(nan)
    got = _port(engine, _y(nan))
    _close(got[0], value, rtol)
    _close(got[1], grad, 1e-8)
    _close(got[2], dtc, rtol)


@pytest.mark.parametrize("engine", ["sequential", "block", "parallel"])
def test_dtc_and_elbo_on_regular_in_time_match_reference(engine):
    """Ragged inputs: C per step, batched; the padding observes nothing."""
    value, grad, dtc = _reference(False, ragged=True)
    got = _port(engine, Y_R, ragged=True)
    _close(got[0], value, 1e-10)
    _close(got[1], grad, 1e-8)
    _close(got[2], dtc, 1e-10)


@functools.lru_cache(maxsize=None)
def _reference_marginals(kind):
    """The reference's approx_posterior_marginals (sequential engine, under
    jax.jit) at X_NEW on the grid ("grid"), on the training RegularInTime
    ("ragged"), or its _at variant at time index 5 ("at")."""
    z = jnp.asarray(Z)
    if kind == "grid":
        fn = lambda p: jst.approx_posterior_marginals(_jfx(p), jnp.asarray(_y(True)), z,
                                                      jnp.asarray(X_NEW), engine="sequential")
    elif kind == "ragged":
        fn = lambda p: jst.approx_posterior_marginals(
            _jfx(p, True), jnp.asarray(Y_R), z, jst.regular_in_time(TIMES, VS),
            engine="sequential")
    else:
        return tuple(np.asarray(a) for a in jst.approx_posterior_marginals_at(
            _jfx(jnp.asarray(P0)), jnp.asarray(_y(True)), z, jnp.asarray(X_NEW), 5))
    return tuple(np.asarray(a) for a in jax.jit(fn)(jnp.asarray(P0)))


@pytest.mark.parametrize("engine", ["sequential", "block", "parallel"])
def test_approx_posterior_marginals_match_reference(engine):
    """At new points on the grid (with a NaN) and on RegularInTime inputs."""
    z = torch.as_tensor(Z)
    got = tt.approx_posterior_marginals(_tfx(torch.tensor(P0)), _y(True), z,
                                        torch.as_tensor(X_NEW), engine=engine)
    want = _reference_marginals("grid")
    _close(got[0], want[0], 1e-8)
    _close(got[1], want[1], 1e-9)
    got = tt.approx_posterior_marginals(_tfx(torch.tensor(P0), True), Y_R, z,
                                        tt.regular_in_time(TIMES, VS), engine=engine)
    want = _reference_marginals("ragged")
    _close(got[0], want[0], 1e-8)
    _close(got[1], want[1], 1e-9)


def test_approx_posterior_marginals_at_matches_reference():
    got = tt.approx_posterior_marginals_at(_tfx(torch.tensor(P0)), _y(True), torch.as_tensor(Z),
                                           torch.as_tensor(X_NEW), 5)
    want = _reference_marginals("at")
    _close(got[0], want[0], 1e-10)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-10)


def _spec(k):
    """The reference kernel as convert.kernel_from_spec's nested spec."""
    name = type(k).__name__
    if name == "Scaled":
        return ("Scaled", _spec(k.kernel), np.asarray(k.sigma2))
    if name == "Stretched":
        return ("Stretched", _spec(k.kernel), np.asarray(k.s))
    if name == "Separable":
        return ("Separable", _spec(k.l), _spec(k.r))
    if name == "DTCSeparable":
        return ("DTCSeparable", np.asarray(k.z), _spec(k.k))
    return (name,)


def test_reference_dtc_model_carried_by_convert():
    """The reference's dtcified kernel, carried across by
    convert.kernel_from_spec, builds the reference's pseudo-point LGSSM (the
    same leaves), whose lml is the dense oracle's (models/naive.py, its
    BottleneckEmissions branch)."""
    jfx = _jfx(jnp.asarray(P0))
    jk = jst.dtcify(jnp.asarray(Z), jfx.f.f.kernel)
    jmodel = japi.build_lgssm(jgp.to_sde(jgp.GP(jk))(jfx.x, jfx.noise))
    tk = convert.kernel_from_spec(_spec(jk))
    tfx = _tfx(torch.tensor(P0))
    tmodel = tgp.build_lgssm(tgp.to_sde(tgp.GP(tk), device="cpu")(tfx.x, tfx.noise))
    assert isinstance(tmodel.emis, BottleneckEmissions)
    for name in ("H", "h", "C", "c", "s_diag"):
        _close(getattr(tmodel.emis, name).value, getattr(jmodel.emis, name).value, 1e-14)
    for name in ("As", "offs", "Qs"):
        _close(getattr(tmodel.trans, name).value, getattr(jmodel.trans, name).value, 1e-14)
    _close(tmodel.trans.x0.cov, jmodel.trans.x0.cov, 1e-14)
    y_tf = torch.as_tensor(_y(False)).reshape(NT, NS)
    # The oracle factors the (240, 240) joint covariance at once: 1e-8.
    _close(tnaive.naive_logpdf(tmodel, y_tf), tlgssm.logpdf(tmodel, y_tf, engine="sequential").item(),
           1e-8)


def test_bottleneck_step_functions_match_reference():
    """project, update, predict, predictive marginals and the conditional
    sample through the bottleneck, batched over two leading axes."""
    rng = np.random.default_rng(3)
    B, D, Mz, Dout = (2, 3), 6, 3, 7
    X = rng.standard_normal(B + (D, D))
    m, P = rng.standard_normal(B + (D,)), X @ np.swapaxes(X, -1, -2) + np.eye(D)
    H, h = rng.standard_normal(B + (Mz, D)), rng.standard_normal(B + (Mz,))
    C, c = rng.standard_normal(B + (Dout, Mz)), rng.standard_normal(B + (Dout,))
    s, y, eps = 0.1 + rng.random(B + (Dout,)), rng.standard_normal(B + (Dout,)), \
        rng.standard_normal(B + (Dout,))
    j, t = (lambda *a: [jnp.asarray(v) for v in a]), (lambda *a: [torch.as_tensor(v) for v in a])
    jx, tx = JGaussian(*j(m, P)), Gaussian(*t(m, P))
    (jpost, jlml), (tpost, tlml) = (jlgc.posterior_and_lml_bottleneck(jx, *j(H, h, C, c, s, y)),
                                    tlgc.posterior_and_lml_bottleneck(tx, *t(H, h, C, c, s, y)))
    for got, want in ((tpost.mean, jpost.mean), (tpost.cov, jpost.cov), (tlml, jlml)):
        _close(got, want, 1e-12)
    tz, jz = tlgc.project_bottleneck(tx, *t(H, h)), jlgc.project_bottleneck(jx, *j(H, h))
    _close(tz.mean, jz.mean, 1e-13)
    _close(tz.cov, jz.cov, 1e-13)
    jp, tp = jlgc.predict_bottleneck(jx, *j(H, h, C, c, s)), tlgc.predict_bottleneck(
        tx, *t(H, h, C, c, s))
    _close(tp.mean, jp.mean, 1e-13)
    _close(tp.cov, jp.cov, 1e-13)
    for got, want in zip(tlgc.predict_marginals_bottleneck(tx, *t(H, h, C, c, s)),
                         jlgc.predict_marginals_bottleneck(jx, *j(H, h, C, c, s))):
        _close(got, want, 1e-13)
    _close(tlgc.conditional_rand_bottleneck(*t(eps, m, H, h, C, c, s)),
           jlgc.conditional_rand_bottleneck(*j(eps, m, H, h, C, c, s)), 1e-13)


def test_elbo_bounds_and_full_inducing_contracts():
    """The reference's contracts (tests/test_space_time.py): the ELBO lower
    bounds the exact lml, and with every spatial point an inducing point dtc
    is the exact lml and the approximate posterior the exact one."""
    fx = _tfx(torch.tensor(P0))
    y = _y(True)
    exact = tt.logpdf(fx, y).item()
    assert tt.elbo(fx, y, torch.as_tensor(Z)).item() <= exact + 1e-8
    full = torch.as_tensor(XL)
    np.testing.assert_allclose(tt.dtc(fx, y, full).item(), exact, rtol=1e-6)
    m, v = tt.approx_posterior_marginals(fx, y, full, full)
    from temporalgps_torch.gp import posterior as tpost

    m_ex, v_ex = tpost.marginals(tpost.posterior(fx, y)(fx.x, 1e-12))
    _close(m, m_ex, 1e-5)
    np.testing.assert_allclose(v.numpy(), v_ex.numpy(), rtol=1e-4, atol=1e-6)


def test_time_invariant_engines_refuse_missing_data():
    """engine="lti" and "steady" take no NaN (the reference's concrete-y
    contract): elbo, dtc and the steady approximate posterior raise."""
    fx, z = _tfx(torch.tensor(P0)), torch.as_tensor(Z)
    for engine in ("lti", "steady"):
        with pytest.raises(ValueError, match="fully-observed"):
            tt.elbo(fx, _y(True), z, engine=engine)
        with pytest.raises(ValueError, match="fully-observed"):
            tt.dtc(fx, _y(True), z, engine=engine)
    with pytest.raises(ValueError, match="fully-observed"):
        tt.approx_posterior_marginals(fx, _y(True), z, torch.as_tensor(X_NEW), engine="steady")
    rit = tgrids.regular_in_time(TIMES, VS)
    with pytest.raises(ValueError, match="all-Fill"):
        tt.elbo(_tfx(torch.tensor(P0), True), Y_R, z, engine="lti")
    assert rit.max_n == NS and len(rit) == len(Y_R)
