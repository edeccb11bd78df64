"""The gradient of the port's fused block logpdf (the torch.autograd.Function
in temporalgps_torch/ops/block.py, whose backward runs the plain blocked
schedule) with respect to (log sigma^2, log stretch, log noise), against
jax.grad through the reference package.

The reference is its block engine with pallas=False for D = 1 and 2. For
D = 3 its reverse-mode block graph takes ~11 s to compile on a CPU, so the
reference there is jax.grad through its sequential engine, which agrees with
the block engine's gradient to rounding. rtol 1e-8 in float64, as the
reference's own Pallas-gradient test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi

import temporalgps_torch as tt
from temporalgps_torch.gp import GP, Matern12, Matern32, Matern52, to_sde

torch.set_num_threads(1)

N, NAN_AT = 37, 11
P0 = np.array([0.1, -0.2, -1.0])  # log sigma^2, log stretch, log noise
TORCH_KERNEL = {"Matern12": Matern12, "Matern32": Matern32, "Matern52": Matern52}


def _y():
    y = np.random.default_rng(3).standard_normal(N)
    y[NAN_AT] = np.nan
    return y


def _jax_grad(name, y, **engine):
    def loss(p):
        s2, sc, noise = jnp.exp(p)
        fx = jgp.to_sde(jgp.GP((s2 * getattr(jgp, name)()).stretch(sc)))(
            JRegularSpacing(0.0, 0.1, N), noise)
        return japi.logpdf(fx, jnp.asarray(y), **engine)

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(P0))
    return float(value), np.asarray(grad)


def _torch_grad(name, y, **engine):
    p = torch.tensor(P0, requires_grad=True)
    s2, sc, noise = torch.exp(p)
    fx = to_sde(GP((s2 * TORCH_KERNEL[name]()).stretch(sc)), device="cpu")(
        tt.RegularSpacing(0.0, 0.1, N), noise)
    lml = tt.logpdf(fx, y, **engine)
    (grad,) = torch.autograd.grad(lml, p)
    return lml.item(), grad.numpy()


@pytest.mark.parametrize(
    "name, reference",
    [
        ("Matern12", dict(engine="block", pallas=False, n_blocks=4)),
        ("Matern32", dict(engine="block", pallas=False, n_blocks=4)),
        ("Matern52", dict(engine="sequential")),
    ],
)
def test_fused_gradient_matches_reference(name, reference):
    y = _y()
    v_ref, g_ref = _jax_grad(name, y, **reference)
    v, g = _torch_grad(name, y, engine="block", fused=True)
    np.testing.assert_allclose(v, v_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-8)


def test_fused_gradient_equals_plain_schedule_gradient():
    y = _y()
    v_f, g_f = _torch_grad("Matern52", y, engine="block", fused=True)
    v_p, g_p = _torch_grad("Matern52", y, engine="block", fused=False)
    assert v_f == v_p
    np.testing.assert_array_equal(g_f, g_p)
