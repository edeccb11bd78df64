"""The port's Kronecker-factored space-time engine (temporalgps_torch/
space_time/kron.py, engine="kron" on the gp verbs) against the reference's
(temporalgps_tpu/space_time/kron.py), and the API leftovers of the reference
that the port now has (SArrayStorage, filter_with_missings,
gaussian_logpdf / gaussian_marginals, dense_posterior_marginals), on the
CPU in float64.

Inputs come from numpy and go through both packages. Sizes and
tolerances are the reference's own kron tests (tests/test_space_time.py):
logpdf and prior marginals 1e-11, the gradient 1e-9, posterior marginals
1e-9 against the reference's kron and 1e-8 / 1e-7 (means / variances)
against the sequential engine, whose smoother carries POSTERIOR_JITTER in
another place.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import dense as jdense
from temporalgps_tpu.gp import posterior as jpost
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.space_time import RectilinearGrid as JGrid
from temporalgps_tpu.space_time import Separable as JSeparable
from temporalgps_tpu.utils import Gaussian as JGaussian
from temporalgps_tpu.utils import gaussian_logpdf as jgaussian_logpdf
from temporalgps_tpu.utils import gaussian_marginals as jgaussian_marginals

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch.gp import dense as tdense
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.models.emissions import map_leaves
from temporalgps_torch.space_time import RectilinearGrid, Separable, kron
from temporalgps_torch.utils import Gaussian, gaussian_logpdf, gaussian_marginals
from temporalgps_torch.utils.fill import Fill, is_fill

torch.set_num_threads(1)


def _close(actual, desired, rtol, atol=None):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=rtol * np.abs(desired).max() if atol is None else atol)


def _fxs(ns, times, noise, kernel=lambda gp, sep: sep(gp.EQ(), gp.Matern52()), mean=None):
    """(reference FiniteLTISDE, port FiniteLTISDE) on linspace(-2, 2, ns) x
    times (an (nt,) array, or a step for RegularSpacing(0, step, nt) given as
    (step, nt)); `mean` a ConstMean's constant."""
    xl = np.linspace(-2.0, 2.0, ns)
    if isinstance(times, tuple):
        jt, tt_ = JRegularSpacing(0.0, *times), tt.RegularSpacing(0.0, *times)
    else:
        jt, tt_ = jnp.asarray(times), torch.as_tensor(times)
    noise = np.asarray(noise)

    def gp(pkg):
        k = kernel(pkg, JSeparable if pkg is jgp else Separable)
        return pkg.GP(k) if mean is None else pkg.GP(k, pkg.ConstMean(mean))

    jfx = jgp.to_sde(gp(jgp))(JGrid(jnp.asarray(xl), jt), jnp.asarray(noise))
    tfx = tgp.to_sde(gp(tgp), device="cpu")(RectilinearGrid(torch.as_tensor(xl), tt_),
                                            torch.as_tensor(noise))
    return jfx, tfx


def _jit(fn, *args):
    """The reference's fn(*args) under one jax.jit: one compile of the
    whole call, several times faster here than its op-by-op dispatch."""
    return jax.jit(fn)(*args)


def _irregular(rng, ns, nt):
    """Irregular times, ConstMean(0.7) and heteroscedastic noise."""
    return _fxs(ns, np.sort(rng.uniform(0, 3, nt)), 0.1 + rng.random(ns * nt) * 0.2, mean=0.7)


def test_logpdf_matches_reference(rng):
    """8 x 25: NaN on a regular grid; irregular times, ConstMean(0.7) and
    heteroscedastic noise."""
    ns, nt = 8, 25
    y = rng.standard_normal(ns * nt)
    y[[2, 40, 111]] = np.nan
    cases = [(_fxs(ns, (0.05, nt), 0.3), y),
             (_irregular(rng, ns, nt), rng.standard_normal(ns * nt))]
    for (jfx, tfx), yc in cases:
        got = tt.logpdf(tfx, yc, engine="kron").item()
        want = _jit(lambda y: jgp.logpdf(jfx, y, engine="kron"), jnp.asarray(yc))
        _close(got, float(want), 1e-11)
        _close(got, tt.logpdf(tfx, yc, engine="sequential").item(), 1e-11)


def test_logpdf_gradient_matches_reference(rng):
    """The autograd gradient of the kron logpdf under s2 * Separable(...)
    against jax.grad of the reference's."""
    ns, nt = 6, 20
    xl = np.linspace(-2, 2, ns)
    y = rng.standard_normal(ns * nt)
    p0 = np.array([0.3, -1.0])

    def loss(pkg, grid, p, ex):
        s2, noise = ex(p)
        sep = JSeparable if pkg is jgp else Separable
        f = pkg.to_sde(pkg.GP(s2 * sep(pkg.EQ(), pkg.Matern52())),
                       **({} if pkg is jgp else {"device": "cpu"}))
        return pkg.logpdf(f(grid, noise), y, engine="kron")

    jgrid = JGrid(jnp.asarray(xl), JRegularSpacing(0.0, 0.05, nt))
    want = _jit(jax.grad(lambda p: loss(jgp, jgrid, p, jnp.exp)), jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    tgrid = RectilinearGrid(torch.as_tensor(xl), tt.RegularSpacing(0.0, 0.05, nt))
    got = torch.autograd.grad(loss(tgp, tgrid, p, torch.exp), p)[0]
    _close(got.numpy(), np.asarray(want), 1e-9)


def test_prior_marginals_match_reference(rng):
    ns, nt = 7, 18
    jfx, tfx = _fxs(ns, (0.05, nt), 0.1 + rng.random(ns * nt) * 0.2,
                    kernel=lambda gp, sep: 1.4 * sep(gp.EQ(), gp.Matern52()))
    got = tt.marginals(tfx, engine="kron")
    for g, want, seq in zip(got, _jit(lambda: jgp.marginals(jfx, engine="kron")),
                            tt.marginals(tfx, engine="sequential")):
        assert g.shape == (ns * nt,)
        _close(g, want, 1e-11)
        _close(g, seq, 1e-11)


def _posterior_cases(jfx, tfx, y, jx, tx, noise):
    """(the port's kron, the reference's kron, the port's sequential)
    posterior marginals of fx given y at (jx, tx) with `noise`. The
    reference merges new times on the host, so only its posterior at the
    training inputs runs under jit."""
    tfp = tpost.posterior(tfx, y)
    ref = lambda: jpost.marginals(jpost.posterior(jfx, jnp.asarray(y))(jx, noise),
                                  engine="kron")
    return (tpost.marginals(tfp(tx, noise), engine="kron"),
            _jit(ref) if jx is jfx.x else ref(),
            tpost.marginals(tfp(tx, noise), engine="sequential"))


def _check_posterior(got, ref, seq):
    for g, r in zip(got, ref):
        _close(g, r, 1e-9)
    np.testing.assert_allclose(got[0].numpy(), seq[0].numpy(), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), seq[1].numpy(), rtol=1e-7, atol=1e-8)


def test_posterior_marginals_at_training_inputs_match_reference(rng):
    """7 x 23, two NaN, prediction noise 0.07 against training noise 0.3;
    then irregular times, ConstMean(0.7), heteroscedastic noise."""
    ns, nt = 7, 23
    y = rng.standard_normal(ns * nt)
    y[[2, 40]] = np.nan
    jfx, tfx = _fxs(ns, (0.05, nt), 0.3)
    _check_posterior(*_posterior_cases(jfx, tfx, y, jfx.x, tfx.x, 0.07))
    jfx, tfx = _irregular(rng, ns, nt)
    y = rng.standard_normal(ns * nt)
    _check_posterior(*_posterior_cases(jfx, tfx, y, jfx.x, tfx.x, 0.05))


def test_posterior_marginals_at_new_times_match_reference(rng):
    """6 x 19, two NaN; new times interleaved with the training ones and
    beyond them (the merged grid's prediction rows are missing steps)."""
    ns, nt = 6, 19
    y = rng.standard_normal(ns * nt)
    y[[3, 17]] = np.nan
    jfx, tfx = _fxs(ns, (0.05, nt), 0.3)
    t_new = np.concatenate([np.linspace(0.012, 0.71, 11), [1.1, 1.37]])
    jx = JGrid(jfx.x.xl, jnp.asarray(t_new))
    tx = RectilinearGrid(tfx.x.xl, torch.as_tensor(t_new))
    got, ref, seq = _posterior_cases(jfx, tfx, y, jx, tx, 0.07)
    assert got[0].shape == (ns * len(t_new),)
    _check_posterior(got, ref, seq)


def test_rand_matches_reference_and_its_moments():
    """rand_with_eps on the reference's normals (its key split in three)
    against its kron.rand; the moments of 4000 draws, as the reference
    checks them; the same draws from the same generator seed."""
    from temporalgps_tpu.space_time import kron as jkron

    ns, nt = 5, 12
    jfx, tfx = _fxs(ns, (0.1, nt), 0.05, kernel=lambda gp, sep: sep(gp.EQ(), gp.Matern32()))
    key = jax.random.PRNGKey(3)
    k0, kt, ke = jax.random.split(key, 3)
    eps = [jax.random.normal(k, shape, jnp.float64)
           for k, shape in ((k0, (2, ns)), (kt, (nt, 2, ns)), (ke, (nt, ns)))]
    got = kron.rand_with_eps(tfx, *(torch.as_tensor(np.array(e)) for e in eps))
    _close(got, _jit(lambda k: jkron.rand(k, jfx), key), 1e-10)

    draws = lambda n: tt.rand(torch.Generator().manual_seed(3), tfx, n, engine="kron")
    ys = draws(4000)
    assert ys.shape == (4000, ns * nt)
    assert torch.equal(ys, draws(4000))
    assert tt.rand(torch.Generator().manual_seed(3), tfx, engine="kron").shape == (ns * nt,)
    m_th, v_th = (t.numpy() for t in tt.marginals(tfx, engine="sequential"))
    np.testing.assert_allclose(ys.mean(0).numpy(), m_th,
                               atol=5 * np.sqrt(np.max(v_th) / 4000) + 1e-3)
    np.testing.assert_allclose(ys.var(0, unbiased=False).numpy(), v_th, rtol=0.15)


def test_kron_refusals():
    """engine="kron" on a model kron does not take raises the reference's
    TypeError through the gp verbs; an LGSSM refuses it with a ValueError."""
    _, tfx = _fxs(4, (0.1, 6), 0.3, kernel=lambda gp, sep: 0.5 * sep(gp.EQ(), gp.Matern32())
                  + 0.5 * sep(gp.EQ(), gp.Matern52()))
    time_series = tgp.to_sde(tgp.GP(tgp.Matern52()), device="cpu")(tt.RegularSpacing(0, 1, 6),
                                                                   0.1)
    y = np.zeros(24)
    for fx in (tfx, time_series):
        assert not kron.supports(fx)
        with pytest.raises(TypeError, match="Separable"):
            tt.logpdf(fx, y[:len(fx)], engine="kron")
        with pytest.raises(TypeError, match="Separable"):
            tt.marginals(fx, engine="kron")
        with pytest.raises(TypeError, match="Separable"):
            tpost.marginals(tpost.posterior(fx, y[:len(fx)])(fx.x, 0.1), engine="kron")
    with pytest.raises(ValueError, match="gp.logpdf"):
        tlgssm.logpdf(tgp.build_lgssm(tfx), y.reshape(6, 4), engine="kron")


def test_engine_none_on_the_cpu_does_not_take_kron(monkeypatch):
    """Without engine=, a supported grid model on the CPU runs the
    materialised engines, whatever the card's rule; the card's rule itself
    (kron.takes_engine_none, which reads no device) takes kron from D = 600
    states, and a float32 model's posterior and rand from D = 300."""
    grid_fx = lambda ns, dtype: tgp.to_sde(
        tgp.GP(Separable(tgp.EQ(), tgp.Matern52())), tgp.ArrayStorage(dtype), device="cpu")(
        RectilinearGrid(torch.linspace(-1, 1, ns, dtype=dtype), tt.RegularSpacing(0.0, 0.1, 4)),
        0.1)
    for ns, dtype, verbs in ((50, torch.float64, ()), (99, torch.float32, ()),
                             (100, torch.float32, ("posterior", "rand")),
                             (199, torch.float64, ()),
                             (200, torch.float64, ("logpdf", "marginals", "posterior", "rand"))):
        fx = grid_fx(ns, dtype)
        for verb in ("logpdf", "marginals", "posterior", "rand"):
            assert kron.takes_engine_none(fx, verb) == (verb in verbs), (ns, dtype, verb)

    _, tfx = _fxs(4, (0.1, 6), 0.3)
    monkeypatch.setattr(kron, "takes_engine_none", lambda fx, verb: True)

    def refuse(*args, **kwargs):
        raise AssertionError("kron ran")

    for name in ("logpdf", "marginals", "posterior_marginals", "rand"):
        monkeypatch.setattr(kron, name, refuse)
    y = np.random.default_rng(0).standard_normal(24)
    assert np.isfinite(tt.logpdf(tfx, y).item())
    assert np.isfinite(tt.marginals(tfx)[1].numpy()).all()
    assert np.isfinite(tpost.marginals(tpost.posterior(tfx, y)(tfx.x, 0.1))[0].numpy()).all()
    assert np.isfinite(tt.rand(torch.Generator().manual_seed(0), tfx).numpy()).all()


# The API leftovers of the reference, each against its counterpart there.

def _time_series(pkg, storage, noise):
    t = np.linspace(0.0, 2.0, 15)
    x = jnp.asarray(t) if pkg is jgp else torch.as_tensor(t)
    kw = {} if pkg is jgp else {"device": "cpu"}
    return pkg.to_sde(pkg.GP(pkg.Matern32().stretch(1.3), pkg.ConstMean(0.4)), storage,
                      **kw)(x, noise)


def test_sarray_storage_matches_reference():
    y = np.random.default_rng(1).standard_normal(15)
    jfx = _time_series(jgp, jgp.SArrayStorage(jnp.float64), 0.2)
    tfx = _time_series(tgp, tgp.SArrayStorage(torch.float64), 0.2)
    assert tgp.build_lgssm(tfx).dtype == torch.float64
    _close(tt.logpdf(tfx, y).item(), float(jgp.logpdf(jfx, jnp.asarray(y))), 1e-12)
    assert tgp.build_lgssm(_time_series(tgp, tgp.SArrayStorage(torch.float32), 0.2)).dtype \
        == torch.float32


def test_filter_with_missings_matches_reference():
    y = np.random.default_rng(2).standard_normal(15)
    y[[0, 6]] = np.nan
    jfx, tfx = _time_series(jgp, None, 0.2), _time_series(tgp, None, 0.2)
    want = jmissings.filter_with_missings(jgp.build_lgssm(jfx), jnp.asarray(y),
                                          engine="sequential")
    got = tmissings.filter_with_missings(tgp.build_lgssm(tfx), torch.as_tensor(y),
                                         engine="sequential")
    _close(got.mean, want.mean, 1e-12)
    _close(got.cov, want.cov, 1e-12)


def test_gaussian_logpdf_and_marginals_match_reference():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4, 3, 3))
    m, P, y = rng.standard_normal((4, 3)), X @ X.transpose(0, 2, 1) + np.eye(3), \
        rng.standard_normal((4, 3))
    jx, tx = JGaussian(jnp.asarray(m), jnp.asarray(P)), Gaussian(torch.as_tensor(m),
                                                                torch.as_tensor(P))
    _close(gaussian_logpdf(tx, torch.as_tensor(y)), jgaussian_logpdf(jx, jnp.asarray(y)), 1e-12)
    for got, want in zip(gaussian_marginals(tx), jgaussian_marginals(jx)):
        _close(got, want, 1e-14)


def test_dense_posterior_marginals_matches_reference():
    y = np.random.default_rng(4).standard_normal(15)
    t_new = np.linspace(0.1, 2.5, 7)
    jfx, tfx = _time_series(jgp, None, 0.2), _time_series(tgp, None, 0.2)
    jpr = jgp.to_sde(jfx.f.f)(jnp.asarray(t_new), 0.05)
    tpr = tgp.to_sde(tfx.f.f, device="cpu")(torch.as_tensor(t_new), 0.05)
    got = tdense.dense_posterior_marginals(tfx, torch.as_tensor(y), tpr)
    for g, want in zip(got, jdense.dense_posterior_marginals(jfx, jnp.asarray(y), jpr)):
        _close(g, want, 1e-10)
    # and the state-space posterior of the port agrees with the dense oracle
    for g, ss in zip(got, tpost.marginals(tpost.posterior(tfx, y)(tpr.x, 0.05))):
        _close(g, ss, 1e-8)


@pytest.mark.parametrize("engine, ns, nt", [("parallel", 125, 3), ("block", 150, 5)])
def test_float32_grid_posterior_of_the_materialised_engines(engine, ns, nt):
    """The materialised engines' float32 posterior on a grid whose D = ns * 3
    is where their float32 filter's covariances were indefinite beyond
    POSTERIOR_JITTER, so the reversal's Cholesky raised (the smallest CPU
    grids that showed it; on the card "parallel" from 125 x 1000 and "block"
    from 200 x 1000). c4's model (chip_smoke.py phase 19). The posterior
    means against the float32 problem (its stored leaves) solved in float64,
    within phase 18's gate: 1e-3, or 4 times the float32 sequential engine's
    distance."""
    kern = tgp.Scaled(Separable(tgp.EQ().stretch(0.7), tgp.Matern52()), 1.0)
    times = tt.RegularSpacing(torch.tensor(0.0, dtype=torch.float32),
                              torch.tensor(0.01, dtype=torch.float32), nt)
    fx = tgp.to_sde(tgp.GP(kern), tgp.ArrayStorage(torch.float32), device="cpu")(
        RectilinearGrid(torch.linspace(-3, 3, ns), times), 0.1)
    y = np.random.default_rng(0).standard_normal(ns * nt)
    y[4321 % (ns * nt)] = np.nan
    model = tgp.build_lgssm(fx)
    y_tf = torch.as_tensor(y, dtype=torch.float32).reshape(nt, ns)

    def means(m, y_, eng):
        post = tmissings.posterior_with_missings(m, y_, engine=eng)
        return tlgssm.marginals_diag(type(m)(post.trans, m.emis), engine="sequential")[0]

    def wide(leaf):
        return Fill(leaf.value.double(), leaf.N) if is_fill(leaf) else leaf.double()

    t = model.trans
    model64 = type(model)(
        dataclasses.replace(t, As=wide(t.As), offs=wide(t.offs), Qs=wide(t.Qs),
                            x0=Gaussian(t.x0.mean.double(), t.x0.cov.double())),
        map_leaves(wide, model.emis))
    truth = means(model64, y_tf.double(), "sequential")
    dist = lambda a: ((a.double() - truth).abs().max() / truth.abs().max()).item()
    got = dist(means(model, y_tf, engine))
    assert got <= max(1e-3, 4.0 * dist(means(model, y_tf, "sequential"))), got
