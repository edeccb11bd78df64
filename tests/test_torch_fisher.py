"""The port's Fisher-identity gradient (temporalgps_torch/ops/fisher.py,
learning.value_and_grad_fisher) against the reference package
(temporalgps_tpu/ops/fisher.py, learning.value_and_grad_fisher) and against
the reference's autodiff gradient, on the CPU in float64.

The port's posterior statistics come from the exact smoother; the
reference's add POSTERIOR_JITTER (1e-10) to each predicted covariance they
invert, which moves its gradient by about 1e-10 / the smallest eigenvalue of
P_pred: negligible on the random models and at lam dt = 0.11 below, 2.2e-5
of a component at lam dt = 2.2e-3 (c2's spacing). So every gradient is held
to the reference's autodiff gradient (jax.grad of its sequential logpdf),
and to the reference's Fisher gradient where its jitter is negligible.
Tolerances: cotangents 1e-8 relative to the largest entry against the
reference's Fisher, rtol 1e-6 / atol 1e-8 against autodiff (the
reference's own test); value 1e-8 and gradient 1e-6 relative per component
for value_and_grad_fisher.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu import learning as jlearning
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.ops import fisher as jfisher
from model_test_utils import random_lgssm
from torch_composite_cases import value

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert, learning
from temporalgps_torch.models.lgssm import model_leaves
from temporalgps_torch.ops import fisher

torch.set_num_threads(1)


def _carry(jmodel):
    t, e = jmodel.trans, jmodel.emis
    return convert.lgssm_from_numpy(
        *(value(leaf) for leaf in (t.As, t.offs, t.Qs, e.H, e.h, e.s)),
        np.asarray(t.x0.mean), np.asarray(t.x0.cov), len(jmodel), dtype=torch.float64,
        device="cpu")


def _leaf_pairs(got, want):
    """(port leaf, reference leaf) of two cotangent LGSSMs, Fills by value."""
    g, w = model_leaves(got), (
        *(value(leaf) for leaf in (want.trans.As, want.trans.offs, want.trans.Qs,
                                   want.emis.H, want.emis.h, want.emis.s)),
        want.trans.x0.mean, want.trans.x0.cov)
    return zip(g, w)


def _sym(x):
    x = np.asarray(x)
    return 0.5 * (x + np.swapaxes(x, -1, -2)) if x.ndim >= 2 and x.shape[-1] == x.shape[-2] else x


@pytest.mark.parametrize("engine", ["block", "parallel"])
@pytest.mark.parametrize("time_varying", [False, True], ids=["fill", "per_step"])
def test_fisher_cotangents_match_reference(time_varying, engine):
    """fisher_cotangents of a random D = 3 scalar-emission model (Fill or
    per-step leaves, N = 16): a Fill leaf's cotangent summed over time, a
    per-step one's per step; against the reference's fisher_cotangents and
    against jax.grad of its sequential logpdf."""
    rng = np.random.default_rng(7)
    jm = random_lgssm(rng, kind="scalar", D=3, Dout=1, N=16, time_varying=time_varying)
    y = rng.standard_normal(16)
    bar, y_bar = fisher.fisher_cotangents(_carry(jm), torch.as_tensor(y), torch.tensor(1.0),
                                          engine=engine)
    ref, y_ref = jfisher.fisher_cotangents(jm, jnp.asarray(y), 1.0, engine="parallel")
    auto, y_auto = jax.grad(lambda m, yy: jlgssm.logpdf(m, yy, engine="sequential"),
                            argnums=(0, 1))(jm, jnp.asarray(y))
    for (g, w), (_, a) in zip(_leaf_pairs(bar, ref), _leaf_pairs(bar, auto)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-8 * np.abs(w).max())
        np.testing.assert_allclose(_sym(g.numpy()), _sym(a), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(y_bar.numpy(), y_ref, rtol=1e-8, atol=1e-8 * np.abs(y_ref).max())
    np.testing.assert_allclose(y_bar.numpy(), y_auto, rtol=1e-6, atol=1e-8)


N = 200
P0 = np.array([0.1, -0.2, -1.0])
P0_SUM = np.array([0.1, -0.2, -0.5, 0.3, -1.0])
# (kernel of the exponentiated parameters as a function of a package's gp
# module, the time step, the initial parameters); the last parameter is the
# log noise variance.
BUILDERS = {
    "c2": (lambda gp, p: (p[0] * gp.Matern52()).stretch(p[1]), 0.05, P0),
    "sum": (lambda gp, p: (p[0] * gp.Matern32()).stretch(p[1])
            + (p[2] * gp.Matern12()).stretch(p[3]), 0.05, P0_SUM),
    "small_lamdt": (lambda gp, p: (p[0] * gp.Matern52()).stretch(p[1]), 1e-3, P0),
}


def _y(nan_at=()):
    y = np.random.default_rng(3).standard_normal(N)
    y[list(nan_at)] = np.nan
    return y


def _model_fns(name):
    kern, dt, p0 = BUILDERS[name]

    def jmodel_fn(p):
        p = jnp.exp(p)
        return japi.build_lgssm(jgp.to_sde(jgp.GP(kern(jgp, p)))(JRegularSpacing(0.0, dt, N),
                                                                  p[-1]))

    def tmodel_fn(p):
        p = torch.exp(p)
        return tgp.build_lgssm(tgp.to_sde(tgp.GP(kern(tgp, p)), device="cpu")(
            tt.RegularSpacing(0.0, dt, N), p[-1]))

    return jmodel_fn, tmodel_fn, p0


@functools.cache
def _reference(name):
    """(the reference's value_and_grad_fisher, its autodiff value_and_grad)
    at the builder's initial parameters, y without NaN."""
    jmodel_fn, _, p0 = _model_fns(name)
    y = jnp.asarray(_y())
    fisher_vg = jax.jit(jlearning.value_and_grad_fisher(jmodel_fn, y))(jnp.asarray(p0))
    auto_vg = jax.jit(jax.value_and_grad(
        lambda p: jlgssm.logpdf(jmodel_fn(p), y, engine="sequential")))(jnp.asarray(p0))
    return [tuple(map(np.asarray, vg)) for vg in (fisher_vg, auto_vg)]


@pytest.mark.parametrize("engine", ["block", "parallel"])
@pytest.mark.parametrize("name", ["c2", "sum", "small_lamdt"])
def test_value_and_grad_fisher_matches_reference(name, engine):
    """value_and_grad_fisher on c2's builder ((s2 * Matern52()).stretch(sc),
    noise; lam dt = 0.11), on a Sum (k = 5) and on c2's builder at lam dt =
    2.2e-3, N = 200: the value within 1e-8 of the reference's; the gradient
    within 1e-6 of the reference's autodiff gradient, and of the reference's
    Fisher gradient except at small lam dt, where the reference's posterior
    jitter moves its gradient by more."""
    _, tmodel_fn, p0 = _model_fns(name)
    (v_ref, g_ref), (v_auto, g_auto) = _reference(name)
    v, g = learning.value_and_grad_fisher(tmodel_fn, _y(), engine=engine)(torch.as_tensor(p0))
    np.testing.assert_allclose(v.item(), v_ref, rtol=1e-8)
    np.testing.assert_allclose(v.item(), v_auto, rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_auto, rtol=1e-6)
    if name != "small_lamdt":
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6)


def test_value_and_grad_fisher_with_missing_observations():
    """NaNs at both ends and inside: filled with their volume added back, as
    logpdf fills them; value and gradient within 1e-8 and 1e-6 of the
    reference's autodiff through its gp-level logpdf (which fills them too)
    and of the port's forward-mode gradient (K4-K6's plain versions)."""
    _, tmodel_fn, p0 = _model_fns("c2")
    kern, dt, _ = BUILDERS["c2"]
    y = _y(nan_at=(0, 17, N - 1))

    def jlogpdf(p):
        p = jnp.exp(p)
        return japi.logpdf(jgp.to_sde(jgp.GP(kern(jgp, p)))(JRegularSpacing(0.0, dt, N), p[-1]),
                           jnp.asarray(y), engine="sequential")

    v_auto, g_auto = map(np.asarray, jax.jit(jax.value_and_grad(jlogpdf))(jnp.asarray(p0)))
    v, g = learning.value_and_grad_fisher(tmodel_fn, y, engine="block")(torch.as_tensor(p0))
    v_fwd, g_fwd = tt.value_and_grad_fwd_lgssm(tmodel_fn, y)(torch.as_tensor(p0))
    for want_v, want_g in ((v_auto, g_auto), (v_fwd.item(), g_fwd.numpy())):
        np.testing.assert_allclose(v.item(), want_v, rtol=1e-8)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6)
