"""Exact space-time inference on the materialised grid in the port
(temporalgps_torch/space_time, the vector emissions of models/ and ops/,
the grid posterior) against the reference (temporalgps_tpu), on the CPU.

Inputs come from numpy and go through both packages, at the reference's
test sizes (tests/test_space_time.py): NS = 4 spatial points, NT = 6 times,
`Separable(EQ(), Matern32())` (D = 8, Dout = 4), per-observation noise
0.25 + U(0, 0.1). The reference is held at its sequential engine: its block
and parallel engines carry the jittered inverse that the port's matrix path
does not. Tolerances: 1e-10 relative for lml, marginals and samples, 1e-9
for the posterior, 1e-8 for gradients (two autodiff systems).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from model_test_utils import random_emissions, random_gauss_markov
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.models import LGSSM as JLGSSM
from temporalgps_tpu.models import emissions as jem
from temporalgps_tpu.gp import posterior as jpost
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.models import naive as jnaive
from temporalgps_tpu.space_time import RectilinearGrid as JGrid
from temporalgps_tpu.space_time import Separable as JSeparable

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.models import naive as tnaive
from temporalgps_torch.models.emissions import LargeEmissions, map_leaves
from temporalgps_torch.models.gauss_markov import GaussMarkov
from temporalgps_torch.space_time import RectilinearGrid, Separable, regular_in_time
from temporalgps_torch.utils.fill import Fill, is_fill, tmaterialize
from temporalgps_torch.utils.gaussian import Gaussian

torch.set_num_threads(1)

NS, NT, NAN_AT = 4, 6, 9
ENGINES = ["sequential", "block", "parallel"]
RNG = np.random.default_rng(7)
XL = np.sort(RNG.uniform(-2.0, 2.0, NS))
TIMES = np.sort(RNG.uniform(0.0, 3.0, NT))
NOISE = 0.25 + RNG.random(NS * NT) * 0.1
Y = RNG.standard_normal(NS * NT)
T_NEW = np.sort(RNG.uniform(0.05, 2.3, 3))
Y_NEW = RNG.standard_normal(NS * 3)
KERNELS = {
    "sep": lambda gp, sep: sep(gp.EQ(), gp.Matern32()),
    "sum": lambda gp, sep: (0.7 * sep(gp.EQ(), gp.Matern32())
                            + 0.3 * sep(gp.EQ(), gp.Matern52())),
}


def _close(actual, desired, rtol):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=rtol * np.abs(desired).max())


def _y(nan=False):
    y = Y.copy()
    if nan:
        y[NAN_AT] = np.nan
    return y


def _fxs(kernel="sep", regular=True, times=None):
    """(reference FiniteLTISDE, port FiniteLTISDE) of one grid model."""
    jt = JRegularSpacing(0.0, 0.4, NT) if regular else jnp.asarray(TIMES)
    tt_ = tt.RegularSpacing(0.0, 0.4, NT) if regular else torch.as_tensor(TIMES)
    jfx = jgp.to_sde(jgp.GP(KERNELS[kernel](jgp, JSeparable)))(JGrid(jnp.asarray(XL), jt),
                                                               jnp.asarray(NOISE))
    tfx = tgp.to_sde(tgp.GP(KERNELS[kernel](tgp, Separable)), device="cpu")(
        RectilinearGrid(torch.as_tensor(XL), tt_), NOISE)
    return jfx, tfx


def _as_float64(model):
    """The model with each leaf cast to float64 (the same model, solved in
    float64)."""
    wide = lambda leaf: Fill(leaf.value.double(), leaf.N) if is_fill(leaf) else leaf.double()
    t = model.trans
    trans = GaussMarkov(As=wide(t.As), offs=wide(t.offs), Qs=wide(t.Qs),
                        x0=Gaussian(t.x0.mean.double(), t.x0.cov.double()))
    return tlgssm.LGSSM(trans, map_leaves(wide, model.emis))


def _new_grids():
    return JGrid(jnp.asarray(XL), jnp.asarray(T_NEW)), RectilinearGrid(torch.as_tensor(XL),
                                                                       torch.as_tensor(T_NEW))


@functools.cache
def _ref_posterior(nan):
    """The reference's posterior marginals at the training inputs and at
    T_NEW, and its posterior logpdf of Y_NEW at T_NEW (sequential)."""
    jfx, _ = _fxs()
    fp = jpost.posterior(jfx, jnp.asarray(_y(nan)))
    jx_new, _ = _new_grids()
    at_tr = jpost.marginals(fp(jfx.x, 0.1), engine="sequential")
    at_new = jpost.marginals(fp(jx_new, 0.1), engine="sequential")
    lp_new = jpost.logpdf(fp(jx_new, 0.1), jnp.asarray(Y_NEW), engine="sequential")
    return [np.asarray(t) for t in (*at_tr, *at_new)], float(lp_new)


@pytest.mark.parametrize("regular", [True, False])
def test_logpdf_and_prior_marginals_match_reference(regular):
    jfx, tfx = _fxs(regular=regular)
    y = _y()
    _close(tt.logpdf(tfx, y).item(), float(jgp.logpdf(jfx, jnp.asarray(y),
                                                      engine="sequential")), 1e-10)
    for got, want in zip(tt.marginals(tfx), jgp.marginals(jfx, engine="sequential")):
        assert got.shape == (NS * NT,)
        _close(got, want, 1e-10)


def test_scaled_sum_of_separables_matches_reference():
    """Also the same kernel built by convert.kernel_from_spec."""
    jfx, tfx = _fxs("sum")
    assert tgp.build_lgssm(tfx).latent_dim == 20
    want = float(jgp.logpdf(jfx, jnp.asarray(_y()), engine="sequential"))
    _close(tt.logpdf(tfx, _y()).item(), want, 1e-10)
    spec = ("Sum", tuple(("Scaled", ("Separable", ("EQ",), (atom,)), w)
                         for atom, w in (("Matern32", 0.7), ("Matern52", 0.3))))
    fx_spec = tgp.to_sde(tgp.GP(convert.kernel_from_spec(spec)), device="cpu")(tfx.x, NOISE)
    _close(tt.logpdf(fx_spec, _y()).item(), want, 1e-10)
    for got, want in zip(tt.marginals(tfx), jgp.marginals(jfx, engine="sequential")):
        _close(got, want, 1e-10)


@pytest.mark.parametrize("engine", ENGINES + ["sqrt"])
def test_engines_match_reference_sequential(engine):
    """lml and the filtering states of the port's engines (the block
    engine's matrix path at n_blocks = 4: the last of 2-step blocks padded;
    the square-root engine's dense-noise elements) against the reference's
    sequential engine."""
    jfx, tfx = _fxs(regular=False)
    y = _y()
    kw = {"n_blocks": 4} if engine == "block" else {}
    _close(tt.logpdf(tfx, y, engine=engine, **kw).item(),
           float(jgp.logpdf(jfx, jnp.asarray(y), engine="sequential")), 1e-10)
    jmodel, tmodel = jgp.build_lgssm(jfx), tgp.build_lgssm(tfx)
    y_tf = torch.as_tensor(y).reshape(NT, NS)
    want = jlgssm.filter_(jmodel, jnp.asarray(y_tf.numpy()), engine="sequential")
    got = tlgssm.filter_(tmodel, y_tf, engine=engine, **kw)
    _close(got.mean, want.mean, 1e-10)
    _close(got.cov, want.cov, 1e-10)


@pytest.mark.parametrize("engine", ENGINES)
def test_posterior_matches_reference(engine):
    """Posterior marginals at the training inputs and at three new times,
    the posterior logpdf at the new times."""
    jfx, tfx = _fxs()
    (m_tr, v_tr, m_new, v_new), lp_new = _ref_posterior(False)
    fp = tpost.posterior(tfx, _y())
    _, tx_new = _new_grids()
    for got, want in zip(tpost.marginals(fp(tfx.x, 0.1), engine=engine), (m_tr, v_tr)):
        _close(got, want, 1e-9)
    for got, want in zip(tpost.marginals(fp(tx_new, 0.1), engine=engine), (m_new, v_new)):
        assert got.shape == (NS * 3,)
        _close(got, want, 1e-9)
    _close(tpost.logpdf(fp(tx_new, 0.1), Y_NEW, engine=engine).item(), lp_new, 1e-9)


def test_rand_with_eps_engines_and_shapes():
    """The same normals through each engine's sample, against the port's
    sequential engine; the prior's and the posterior's sample shapes."""
    _, tfx = _fxs()
    model = tgp.build_lgssm(tfx)
    D = model.latent_dim
    rng = np.random.default_rng(3)
    eps_t, eps_e, x_init = (torch.as_tensor(rng.standard_normal(s))
                            for s in ((NT, D), (NT, NS), (D,)))
    want = tlgssm.rand_with_eps(model, eps_t, eps_e, x_init, engine="sequential")
    assert want.shape == (NT, NS)
    for engine in ("block", "parallel"):
        _close(tlgssm.rand_with_eps(model, eps_t, eps_e, x_init, engine=engine), want, 1e-10)
    gen = torch.Generator().manual_seed(0)
    ys = tt.rand(gen, tfx)
    assert ys.shape == (NS * NT,) and bool(torch.isfinite(ys).all())
    assert tt.rand(gen, tfx, 3).shape == (3, NS * NT)
    _, tx_new = _new_grids()
    assert tpost.rand(gen, tpost.posterior(tfx, _y())(tx_new, 0.1)).shape == (NS * 3,)


def test_naive_oracle_matches_reference_and_the_sequential_engine():
    jfx, tfx = _fxs()
    jmodel, tmodel = jgp.build_lgssm(jfx), tgp.build_lgssm(tfx)
    y_tf = _y().reshape(NT, NS)
    lp = tnaive.naive_logpdf(tmodel, y_tf)
    _close(lp, jnaive.naive_logpdf(jmodel, y_tf), 1e-10)
    _close(lp, tlgssm.logpdf(tmodel, torch.as_tensor(y_tf), engine="sequential").item(), 1e-10)
    got, want = tnaive.naive_posterior_marginals(tmodel, y_tf), \
        jnaive.naive_posterior_marginals(jmodel, y_tf)
    for g, w in zip(got, want):
        _close(np.stack(g), np.stack(w), 1e-10)
    # The smoother inverts each step's dynamics against its predicted
    # covariance plus POSTERIOR_JITTER = 1e-10 (the reference's), which moves
    # these posterior means by ~3e-9 of the largest from the exact oracle.
    post = tlgssm.marginals(tlgssm.posterior(tmodel, torch.as_tensor(y_tf)))
    _close(post.mean, np.stack(got[0]), 1e-8)
    _close(post.cov, np.stack(got[1]), 1e-8)


def test_random_vector_emission_models_match_reference():
    """A random time-varying chain under random dense-noise emissions (the
    port's model by convert.dense_lgssm_from_numpy) and under diagonal-noise
    ones (LargeEmissions), one observation NaN: on each engine the lml, the
    filtering states and the posterior's observation marginals against the
    reference's sequential engine, a sample on the same normals against the
    port's sequential engine (whose observation noise is held to the
    reference's step function); the naive oracle against the reference's."""
    rng = np.random.default_rng(11)
    N, D, Dout = 7, 3, 4
    jtrans = random_gauss_markov(rng, D, N)
    jemis = {kind: random_emissions(rng, kind, D, Dout, N) for kind in ("dense", "large")}
    y = rng.standard_normal((N, Dout))
    y[2, 1] = np.nan
    eps = [torch.as_tensor(rng.standard_normal(s)) for s in ((N, D), (N, Dout), (D,))]
    t = jtrans
    dense = convert.dense_lgssm_from_numpy(t.As, t.offs, t.Qs, jemis["dense"].H, jemis["dense"].h,
                                           jemis["dense"].S, t.x0.mean, t.x0.cov, N,
                                           dtype=torch.float64, device="cpu")
    large = tlgssm.LGSSM(dense.trans, LargeEmissions(
        *(torch.as_tensor(np.asarray(v)) for v in (jemis["large"].C, jemis["large"].c,
                                                   jemis["large"].s_diag))))
    for kind, tmodel in (("dense", dense), ("large", large)):
        jmodel = JLGSSM(jtrans, jemis[kind])
        jm_f, jy_f, _ = jmissings.transform_model_and_obs(jmodel, jnp.asarray(y))
        tm_f, ty_f, _ = tmissings.transform_model_and_obs(tmodel, torch.as_tensor(y))
        want_lp = float(jmissings.logpdf_with_missings(jmodel, jnp.asarray(y),
                                                       engine="sequential"))
        want_f = jlgssm.filter_(jm_f, jy_f, engine="sequential")
        want_m = jlgssm.marginals_diag(jlgssm.posterior(jm_f, jy_f, engine="sequential"),
                                       engine="sequential")
        want_s = tlgssm.rand_with_eps(tmodel, *eps, engine="sequential")
        # The observation noise of the sample: the reference's step function.
        noise = (np.asarray(jem.step_conditional_rand(jnp.asarray(eps[1].numpy()),
                                                      jnp.zeros((N, D)), jemis[kind]))
                 - np.asarray(jem.step_conditional_rand(jnp.zeros((N, Dout)), jnp.zeros((N, D)),
                                                        jemis[kind])))
        _close(want_s - tlgssm.rand_with_eps(tmodel, eps[0], torch.zeros_like(eps[1]), eps[2],
                                             engine="sequential"), noise, 1e-10)
        for engine in ENGINES + ["sqrt"]:
            kw = {"n_blocks": 3} if engine == "block" else {}
            _close(tmissings.logpdf_with_missings(tmodel, torch.as_tensor(y), engine=engine,
                                                  **kw).item(), want_lp, 1e-10)
            got = tlgssm.filter_(tm_f, ty_f, engine=engine, **kw)
            _close(got.mean, want_f.mean, 1e-10)
            _close(got.cov, want_f.cov, 1e-10)
            post = tlgssm.posterior(tm_f, ty_f, engine=engine, **kw)
            for g, w in zip(tlgssm.marginals_diag(post, engine="sequential"), want_m):
                _close(g, w, 1e-9)
            if engine != "sqrt":
                _close(tlgssm.rand_with_eps(tmodel, *eps, engine=engine, **kw), want_s, 1e-10)
        _close(tnaive.naive_logpdf(tmodel, np.nan_to_num(y)),
               jnaive.naive_logpdf(jmodel, np.nan_to_num(y)), 1e-10)
        for g, w in zip(tnaive.naive_posterior_marginals(tmodel, np.nan_to_num(y)),
                        jnaive.naive_posterior_marginals(jmodel, np.nan_to_num(y))):
            _close(np.stack(g), np.stack(w), 1e-10)


def test_missing_observation_matches_reference():
    """One NaN: the lml and the posterior marginals, and the dense noise
    fill entry by entry (LARGE_VAR on the diagonal, the entry's row and
    column zero)."""
    jfx, tfx = _fxs()
    y = _y(nan=True)
    _close(tt.logpdf(tfx, y).item(), float(jgp.logpdf(jfx, jnp.asarray(y),
                                                      engine="sequential")), 1e-10)
    (m_tr, v_tr, m_new, v_new), _ = _ref_posterior(True)
    fp = tpost.posterior(tfx, y)
    for got, want in zip(tpost.marginals(fp(tfx.x, 0.1), engine="block"), (m_tr, v_tr)):
        _close(got, want, 1e-10)
    S = tmaterialize(tgp.build_lgssm(tfx).emis.S)
    y_tf = y.reshape(NT, NS)
    got = tmissings.fill_in_missings(S, torch.as_tensor(y_tf))
    want = jmissings.fill_in_missings(jnp.asarray(S.numpy()), jnp.asarray(y_tf))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) == 1


def test_refusals():
    _, tfx = _fxs()
    with pytest.raises(ValueError, match="gp.logpdf"):
        tlgssm.logpdf(tgp.build_lgssm(tfx), _y().reshape(NT, NS), engine="kron")
    # A RegularInTime takes the pseudo-point verbs only; the pseudo-point
    # model takes no mean function.
    rit = regular_in_time(np.arange(2.0), [np.zeros(3), np.zeros(2)])
    with pytest.raises(TypeError, match="RectilinearGrid"):
        tgp.build_lgssm(tgp.to_sde(tgp.GP(Separable(tgp.EQ(), tgp.Matern32())),
                                   device="cpu")(rit, 0.1))
    with pytest.raises(NotImplementedError, match="zero mean"):
        tt.dtc(tgp.to_sde(tgp.GP(Separable(tgp.EQ(), tgp.Matern32()), tgp.ConstMean(1.0)),
                          device="cpu")(tfx.x, NOISE), _y(), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="item 9"):
        tt.logpdf(tgp.to_sde(tgp.GP(tgp.EQ()), device="cpu")(torch.arange(3.0), 0.1),
                  np.zeros(3))
    other = RectilinearGrid(torch.as_tensor(XL + 0.1), torch.as_tensor(T_NEW))
    with pytest.raises(ValueError, match="Space coords"):
        tpost.marginals(tpost.posterior(tfx, _y())(other, 0.1))


def test_learning_objective_gradient_matches_jax_grad():
    """The objective of examples/exact_space_time_learning.py (kernel
    variance, two inverse lengthscales, noise), autograd against jax.grad."""
    p0 = np.log([0.8, 0.9, 1.2, 0.3])
    y = _y(nan=True)

    def objective(gp, sep, exp, grid, x, xl, times):
        def f(p):
            kern = exp(p[0]) * sep(gp.EQ().stretch(exp(p[1])), gp.Matern52().stretch(exp(p[2])))
            fx = gp.to_sde(gp.GP(kern), **({} if gp is jgp else {"device": "cpu"}))(
                grid(xl, times), exp(p[3]))
            return -gp.logpdf(fx, x) / (NS * NT)
        return f

    jf = objective(jgp, JSeparable, jnp.exp, JGrid, jnp.asarray(y), jnp.asarray(XL),
                   jnp.asarray(TIMES))
    tf = objective(tgp, Separable, torch.exp, RectilinearGrid, torch.as_tensor(y),
                   torch.as_tensor(XL), torch.as_tensor(TIMES))
    p = torch.tensor(p0, requires_grad=True)
    value = tf(p)
    (grad,) = torch.autograd.grad(value, p)
    _close(value.item(), float(jf(jnp.asarray(p0))), 1e-10)
    _close(grad.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(p0))), 1e-8)


def test_float32_big_grid_engines():
    """The reference's float32 regression shape (ns = 20, nt = 50, D = 60,
    Dout = 20, n_blocks = 7 with a padded tail): the float32 block and
    parallel engines against the float32 model solved in float64 by the
    sequential engine (the float32 model carries the float32 jitter on the
    spatial gram, 1e-5 of its mean diagonal, which moves the lml by ~7e-5
    from the float64 model's: a model difference, not arithmetic)."""
    ns, nt = 20, 50
    r = torch.as_tensor(np.linspace(-3, 3, ns), dtype=torch.float32)
    x = RectilinearGrid(r, tt.RegularSpacing(torch.tensor(0.0), torch.tensor(0.01), nt))
    fx = tgp.to_sde(tgp.GP(Separable(tgp.EQ().stretch(0.7), tgp.Matern52())),
                    tgp.ArrayStorage(torch.float32), device="cpu")(x, torch.tensor(0.1))
    model = tgp.build_lgssm(fx)
    y = torch.as_tensor(np.random.default_rng(5).standard_normal((nt, ns)), dtype=torch.float32)
    wide = _as_float64(model)
    want = tlgssm.logpdf(wide, y.double(), engine="sequential").item()
    for engine, kw in (("block", {"n_blocks": 7}), ("parallel", {})):
        got = tlgssm.logpdf(model, y, engine=engine, **kw)
        assert got.dtype == torch.float32
        _close(got.item(), want, 5e-5)
