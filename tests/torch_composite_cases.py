"""Models, inputs and reference helpers shared by tests/test_torch_composite.py
and tests/test_torch_sampling.py: composite kernels written once as functions
of a package's `gp` module and built by both packages, one mean function of
the times for both, N = 40 regularly spaced or irregular times, noise 0.1,
y with NaNs, and the reference's jitted functions cached across cases."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import missings as jmissings

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert

N, NOISE, B = 40, 0.1, 4
TIMES = np.cumsum(np.random.default_rng(0).uniform(0.05, 0.15, N))
KERNELS = {
    "sum3": lambda gp: 0.5 * gp.Matern12().stretch(2.0) + gp.Matern32().stretch(0.5),
    "prod2": lambda gp: gp.Matern12() * gp.Matern32(),
    "sum5": lambda gp: gp.Matern52() + gp.Matern32(),
}


def mean_fn(t):
    """One mean function of the times for both packages."""
    return 0.4 - 0.3 * t + 0.05 * t * t


def close(actual, desired, rtol=1e-9):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=rtol * np.abs(desired).max())


def make_y(seed=1, nan_at=(5,)):
    y = np.random.default_rng(seed).standard_normal(N)
    y[list(nan_at)] = np.nan
    return y


def fxs(name, irregular=False, custom_mean=False):
    """(reference FiniteLTISDE, port FiniteLTISDE) of one model."""
    jx = jnp.asarray(TIMES) if irregular else JRegularSpacing(0.0, 0.1, N)
    tx = torch.as_tensor(TIMES) if irregular else tt.RegularSpacing(0.0, 0.1, N)
    jmean = jgp.CustomMean(mean_fn) if custom_mean else jgp.ZeroMean()
    tmean = tgp.CustomMean(mean_fn) if custom_mean else tgp.ZeroMean()
    jfx = jgp.to_sde(jgp.GP(KERNELS[name](jgp), jmean))(jx, NOISE)
    tfx = tgp.to_sde(tgp.GP(KERNELS[name](tgp), tmean), tgp.ArrayStorage(torch.float64),
                     device="cpu")(tx, NOISE)
    return jfx, tfx


def leaves(model):
    t, e = model.trans, model.emis
    return (t.As, t.offs, t.Qs, e.H, e.h, e.s)


def value(leaf):
    return np.asarray(getattr(leaf, "value", leaf))


def carry(jmodel, forward):
    return convert.lgssm_from_numpy(
        *(value(leaf) for leaf in leaves(jmodel)), np.asarray(jmodel.trans.x0.mean),
        np.asarray(jmodel.trans.x0.cov), N, dtype=torch.float64, device="cpu",
        forward=forward)


@functools.cache
def jitted(fn, **kwargs):
    return jax.jit(functools.partial(fn, **kwargs))


@functools.cache
def reference_posterior(name, engine="sequential", irregular=True, custom_mean=True):
    """(reference prior LGSSM, its posterior given y with NaNs on `engine`,
    the port's copies of both) of a model, by default on the irregular
    times with the mean function."""
    jfx, _ = fxs(name, irregular, custom_mean)
    jmodel = japi.build_lgssm(jfx)
    jpost_model = jitted(jmissings.posterior_with_missings, engine=engine)(
        jmodel, jnp.asarray(make_y()))
    return jmodel, jpost_model, carry(jmodel, True), carry(jpost_model, False)
