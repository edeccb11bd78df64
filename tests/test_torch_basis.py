"""The basis engine in the port (temporalgps_torch/ops/basis.py, gp.lti_sde
`basis_setup`, `logpdf(engine="basis")`): deterministic kernel summands as
marginalised basis functions, against the reference package on the CPU,
float64. Mirrors tests/test_basis_engine.py, except its
`test_basis_jit_and_no_retrace` (jax.jit's tracing has no counterpart here)
and `test_basis_steady_head_dtype_plumbs` (the port's head is float64, the
reference's default, and has no `head_dtype` option).

The truth is the reference's sequential engine on the FULL state-space
model: its own basis engine inverts I + C J with a jitter and sits ~1e-8
from it, the port's sub-engines ~1e-14. Tolerances: the reference's test's
1e-8 relative for the lml (1e-10 where no basis is involved), 1e-6 for the
gradient; 1e-9 / 1e-6 between the port's steady and block sub-engines; the
Fisher gradient 1e-4, the reference's rule for it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import kernels as jkernels
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.space_time import RectilinearGrid as JRectilinearGrid
from temporalgps_tpu.space_time import Separable as JSeparable

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch.gp import kernels as tkernels
from temporalgps_torch.gp import lti_sde as tapi
from temporalgps_torch.ops import basis
from temporalgps_torch.space_time import RectilinearGrid, Separable, dtcify, elbo

torch.set_num_threads(1)

KERN_C3 = lambda m: (m.Matern52() + 0.6 * m.Matern32().stretch(0.5)
                     + 0.3 * m.ApproxPeriodic(0.5, n_cos=3))
KERN_MIX = lambda m: m.Matern32() + m.Cosine().stretch(2.0) + m.Constant(0.7)


def _data(N, seed=0):
    return np.random.default_rng(seed).standard_normal(N)


def _fxs(kern, jx, tx, noise, mean=None):
    """The same fx in both packages; `mean(m)` builds a mean function."""
    jgp_ = jgp.GP(kern(jgp)) if mean is None else jgp.GP(kern(jgp), mean(jgp))
    tgp_ = tgp.GP(kern(tgp)) if mean is None else tgp.GP(kern(tgp), mean(tgp))
    return jgp.to_sde(jgp_)(jx, noise), tgp.to_sde(tgp_, device="cpu")(tx, noise)


def _reference_lml(jfx, y):
    """The reference's sequential engine on the full model, jitted."""
    return float(jax.jit(lambda yy: japi.logpdf(jfx, yy, engine="sequential"))(jnp.asarray(y)))


def _close(actual, desired, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(actual).detach()),
                               np.asarray(desired), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kern", [KERN_C3, KERN_MIX], ids=["c3", "mix"])
@pytest.mark.parametrize("sub_engine", ["sequential", "block"])
def test_basis_matches_full_model(kern, sub_engine, monkeypatch):
    """Each sub-engine against the reference's full-model sequential lml;
    engine=None routes to the basis engine, as the reference's does."""
    N = 256
    jfx, tfx = _fxs(kern, JRegularSpacing(0.0, 0.05, N), tt.RegularSpacing(0.0, 0.05, N), 0.1)
    y = _data(N)
    lp = tt.logpdf(tfx, y, engine="basis", sub_engine=sub_engine)
    _close(lp, _reference_lml(jfx, y), 1e-8)
    calls = []
    real = basis.logpdf_basis
    monkeypatch.setattr(basis, "logpdf_basis",
                        lambda *a, **kw: calls.append(kw["engine"]) or real(*a, **kw))
    lp_none = tt.logpdf(tfx, y, sub_engine=sub_engine)
    assert calls == [sub_engine]
    _close(lp_none, lp, 1e-14)


def test_basis_irregular_times_and_mean():
    N = 200
    t = np.sort(np.random.default_rng(1).uniform(0.0, 15.0, N))
    y = _data(N, 1) + 0.7
    jfx, tfx = _fxs(KERN_MIX, t, torch.as_tensor(t), 0.05, mean=lambda m: m.ConstMean(0.7))
    _close(tt.logpdf(tfx, y, engine="basis"), _reference_lml(jfx, y), 1e-8)


def test_basis_missing_data():
    N = 256
    y = _data(N)
    y[::5] = np.nan
    kern = lambda m: m.Matern52() + 0.3 * m.ApproxPeriodic(0.5, n_cos=2)
    jfx, tfx = _fxs(kern, JRegularSpacing(0.0, 0.05, N), tt.RegularSpacing(0.0, 0.05, N), 0.1)
    ref = _reference_lml(jfx, y)
    for sub_engine in ("sequential", "block"):
        _close(tt.logpdf(tfx, y, engine="basis", sub_engine=sub_engine), ref, 1e-8)


def test_basis_no_det_component_passthrough():
    N = 128
    y = _data(N)
    jfx, tfx = _fxs(lambda m: m.Matern52(), JRegularSpacing(0.0, 0.05, N),
                    tt.RegularSpacing(0.0, 0.05, N), 0.1)
    model, M, P0 = tgp.basis_setup(tfx)
    assert M is None and P0 is None and not model.trans.det_blocks
    _close(tt.logpdf(tfx, y, engine="basis"), _reference_lml(jfx, y), 1e-10)


def test_basis_pure_deterministic_raises():
    fx = tgp.to_sde(tgp.GP(tgp.Cosine()), device="cpu")(tt.RegularSpacing(0.0, 0.05, 32), 0.1)
    with pytest.raises(TypeError, match="stochastic"):
        tt.logpdf(fx, _data(32), engine="basis")


def test_split_deterministic():
    """The port's split has the reference's shape on each case."""
    cases = [KERN_C3, lambda m: m.Matern32() * m.Cosine(), lambda m: m.Cosine() * m.Cosine(),
             lambda m: 2.0 * (m.Matern12() + m.Cosine()).stretch(0.5)]
    want = [(2, 1), (1, 0), (0, 1), (1, 1)]
    for case, (n_s, n_d) in zip(cases, want):
        s, d = tkernels.split_deterministic(case(tgp))
        js, jd = jkernels.split_deterministic(case(jgp))
        assert (len(s), len(d)) == (len(js), len(jd)) == (n_s, n_d)
        t = np.linspace(0.0, 2.0, 7)
        for part, jpart in ((s, js), (d, jd)):
            for k, jk in zip(part, jpart):
                _close(tkernels.gram(k, torch.as_tensor(t)), jkernels.gram(jk, jnp.asarray(t)),
                       1e-14)


def test_det_basis_columns_reproduce_gram():
    """M(t) P0 M(t')^T equals the deterministic kernel's gram (n_cos = 12:
    the cosine series' truncation ~1e-13 at r = 0.6), and M, P0 the
    reference's."""
    t = np.sort(np.random.default_rng(2).uniform(0.0, 8.0, 40))
    for kern in [lambda m: m.Cosine(), lambda m: m.Constant(0.5),
                 lambda m: 0.4 * m.ApproxPeriodic(0.6, n_cos=12),
                 lambda m: m.Cosine().stretch(1.7), lambda m: m.Cosine() * m.Cosine()]:
        k = kern(tgp)
        tau = torch.as_tensor(t - t[0])
        M, P0 = tkernels.det_basis_columns(k, tau, torch.float64, "cpu")
        _close(M @ P0 @ M.T, tkernels.gram(k, torch.as_tensor(t)), 0.0, 1e-9)
        jM, jP0 = jkernels.det_basis_columns(kern(jgp), jnp.asarray(t - t[0]))
        _close(M, jM, 1e-12, 1e-14)
        _close(P0, jP0, 1e-12)


def test_basis_forward_mode_gradient_matches_reference_autodiff():
    """learning.value_and_grad_fwd through the basis engine against
    jax.value_and_grad of the reference's full-model sequential engine."""
    N = 192
    y = _data(N, 3)

    def jloss(p):
        s2, sc, noise = jnp.exp(p)
        kern = s2 * jgp.Matern52() + 0.3 * jgp.ApproxPeriodic(sc, n_cos=2)
        return japi.logpdf(jgp.to_sde(jgp.GP(kern))(JRegularSpacing(0.0, 0.05, N), noise),
                           jnp.asarray(y), engine="sequential")

    def tloss(p):
        s2, sc, noise = torch.exp(p)
        kern = s2 * tgp.Matern52() + 0.3 * tgp.ApproxPeriodic(sc, n_cos=2)
        return tt.logpdf(tgp.to_sde(tgp.GP(kern), device="cpu")(tt.RegularSpacing(0.0, 0.05, N),
                                                                 noise), y, engine="basis")

    v_ref, g_ref = jax.jit(jax.value_and_grad(jloss))(jnp.asarray([0.1, -0.5, -2.0]))
    v, g = tt.value_and_grad_fwd(tloss)(torch.tensor([0.1, -0.5, -2.0], dtype=torch.float64))
    _close(v, v_ref, 1e-9)
    _close(g, g_ref, 1e-6)


def _c3_loss(N, y, **kw):
    x = tt.RegularSpacing(0.0, 0.05, N)

    def loss(p):
        s2, sc, noise = torch.exp(p)
        kern = (s2 * tgp.Matern52() + 0.6 * tgp.Matern32().stretch(sc)
                + 0.3 * tgp.ApproxPeriodic(0.5, n_cos=3))
        return tt.logpdf(tgp.to_sde(tgp.GP(kern), device="cpu")(x, noise), y, engine="basis",
                         **kw)

    return loss


def _value_and_grad(loss, p0):
    p = p0.clone().requires_grad_()
    v = loss(p)
    return v.detach(), torch.autograd.grad(v, p)[0]


def test_basis_steady_matches_block():
    """The steady sub-engine (exact float64 head, constant-gain late
    segment) against block, lml and reverse-mode gradient; its forward-mode
    gradient (fwd_mode=True, no autograd.Function) equals its reverse one."""
    N = 2048
    y = torch.as_tensor(_data(N, 7))
    p0 = torch.tensor([0.1, -0.3, -1.5], dtype=torch.float64)
    v_b, g_b = _value_and_grad(_c3_loss(N, y, sub_engine="block"), p0)
    v_s, g_s = _value_and_grad(_c3_loss(N, y, sub_engine="steady", n_warmup=512), p0)
    _close(v_s, v_b, 1e-9)
    _close(g_s, g_b, 1e-6)
    v_f, g_f = tt.value_and_grad_fwd(_c3_loss(N, y, sub_engine="steady", n_warmup=512,
                                              fwd_mode=True))(p0)
    _close(v_f, v_s, 1e-12)
    _close(g_f, g_s, 1e-9)


def test_basis_steady_nan_contract():
    """NaNs raise on the steady sub-engine; the block one scores them."""
    N = 1024
    y = _data(N, 8)
    y[::7] = np.nan
    kern = lambda m: m.Matern52() + 0.3 * m.ApproxPeriodic(0.5, n_cos=2)
    jfx, tfx = _fxs(kern, JRegularSpacing(0.0, 0.05, N), tt.RegularSpacing(0.0, 0.05, N), 0.1)
    with pytest.raises(ValueError, match="fully-observed"):
        tt.logpdf(tfx, y, engine="basis", sub_engine="steady")
    _close(tt.logpdf(tfx, y, engine="basis", sub_engine="block"), _reference_lml(jfx, y), 1e-8)


@pytest.mark.parametrize("engine", ["block", "parallel"])
def test_fisher_gradient_on_det_model_matches_reference_autodiff(engine):
    """value_and_grad_fisher on a full-state model with deterministic blocks
    (Q = 0 there): the innovations form is the exact score for a
    semidefinite Q. Against the reference's autodiff of its sequential
    engine at the reference's 1e-4."""
    N = 128
    y = _data(N, 11)

    def jbuild(p):
        s2, sc, noise = jnp.exp(p)
        kern = s2 * jgp.Matern52() + 0.3 * jgp.ApproxPeriodic(sc, n_cos=2)
        return japi.build_lgssm(jgp.to_sde(jgp.GP(kern))(JRegularSpacing(0.0, 0.05, N), noise))

    from temporalgps_tpu.models import lgssm as jlgssm

    g_ref = jax.jit(jax.grad(lambda p: jlgssm.logpdf(jbuild(p), jnp.asarray(y),
                                                     engine="sequential")))(
        jnp.asarray([0.1, -0.5, -1.5]))

    def model_fn(p):
        s2, sc, noise = torch.exp(p)
        kern = s2 * tgp.Matern52() + 0.3 * tgp.ApproxPeriodic(sc, n_cos=2)
        return tgp.build_lgssm(tgp.to_sde(tgp.GP(kern), device="cpu")(
            tt.RegularSpacing(0.0, 0.05, N), noise))

    model = model_fn(torch.tensor([0.1, -0.5, -1.5], dtype=torch.float64))
    assert model.trans.det_blocks
    _, g = tt.value_and_grad_fisher(model_fn, y, engine=engine)(
        torch.tensor([0.1, -0.5, -1.5], dtype=torch.float64))
    _close(g, g_ref, 1e-4)


def test_steady_refuses_det_space_time_models():
    """engine="steady" refuses a grid model whose temporal kernel has a
    deterministic summand, with the reference's ValueError; so does the
    pseudo-point elbo on it."""
    xl = np.linspace(-1.0, 1.0, 3)
    y = _data(3 * 20, 12)
    jfx = jgp.to_sde(jgp.GP(JSeparable(jgp.EQ(), jgp.Matern52() + jgp.Cosine())))(
        JRectilinearGrid(jnp.asarray(xl), JRegularSpacing(0.0, 0.1, 20)), 0.1)
    tfx = tgp.to_sde(tgp.GP(Separable(tgp.EQ(), tgp.Matern52() + tgp.Cosine())), device="cpu")(
        RectilinearGrid(torch.as_tensor(xl), tt.RegularSpacing(0.0, 0.1, 20)), 0.1)
    with pytest.raises(ValueError, match="deterministic"):
        japi.logpdf(jfx, jnp.asarray(y), engine="steady")
    with pytest.raises(ValueError, match="deterministic"):
        tt.logpdf(tfx, y, engine="steady")
    assert tapi.build_lgssm(dtcify(torch.as_tensor(xl[:2]), tfx)).trans.det_blocks
    with pytest.raises(ValueError, match="deterministic"):
        elbo(tfx, y, torch.as_tensor(xl[:2]), engine="steady")
    _close(tt.logpdf(tfx, y, engine="sequential"),
           jax.jit(lambda: japi.logpdf(jfx, jnp.asarray(y), engine="sequential"))(), 1e-10)
