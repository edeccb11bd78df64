"""The port's learning utilities (temporalgps_torch/learning.py) against the
reference package's (temporalgps_tpu/learning.py), on the CPU in float64,
and the port's device default.

Adam: torch.optim.Adam and optax.adam apply the same update rule with the
same eps placement, so from the same start the loss trajectories agree to
rounding: rtol 1e-8 over five steps. L-BFGS: the two line searches differ
(strong Wolfe here, optax's zoom search there), so the iterates differ and
only the optimum is compared, parameters within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu import learning as jlearning
from temporalgps_tpu.gp import lti_sde as japi

import temporalgps_torch as tt
from temporalgps_torch import convert, learning
from temporalgps_torch.gp import GP, LTISDE, Matern32, Matern52, build_lgssm, kernels, to_sde

torch.set_num_threads(1)

N, NAN_AT, DT = 30, 4, 0.25
P0 = np.array([0.3, -0.2, -0.5])  # log sigma^2, log stretch, log noise


def _y():
    t = DT * np.arange(N)
    y = np.sin(1.7 * t) + 0.3 * np.random.default_rng(11).standard_normal(N)
    y[NAN_AT] = np.nan
    return y


def _jax_objective(y):
    def objective(p):
        s2, sc, noise = jnp.exp(p)
        fx = jgp.to_sde(jgp.GP((s2 * jgp.Matern32()).stretch(sc)))(
            JRegularSpacing(0.0, DT, N), noise)
        return -japi.logpdf(fx, jnp.asarray(y), engine="sequential")

    return objective


def _torch_fx(p):
    s2, sc, noise = torch.exp(p)
    return to_sde(GP((s2 * Matern32()).stretch(sc)), device="cpu")(
        tt.RegularSpacing(0.0, DT, N), noise)


def _torch_objective(y):
    return lambda p: -tt.logpdf(_torch_fx(p), y, engine="sequential")


def test_fit_adam_follows_the_reference_loss_trajectory():
    y = _y()
    ref = jlearning.fit(_jax_objective(y), jnp.asarray(P0), steps=5)
    got = tt.fit(_torch_objective(y), torch.from_numpy(P0), steps=5)
    assert got.losses.shape == (5,)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params), rtol=1e-8)
    assert got.losses[-1] < got.losses[0]


def test_fit_on_the_fused_forward_gradient_equals_fit_on_autograd():
    y = _y()
    vg = tt.value_and_grad_fwd_lgssm(lambda p: build_lgssm(_torch_fx(p)), y, n_blocks=4)

    def neg_vg(p):
        value, grad = vg(p)
        return -value, -grad

    fused = tt.fit(neg_vg, torch.from_numpy(P0), steps=4, has_grad=True)
    auto = tt.fit(_torch_objective(y), torch.from_numpy(P0), steps=4)
    np.testing.assert_allclose(fused.losses.numpy(), auto.losses.numpy(), rtol=1e-9)
    np.testing.assert_allclose(fused.params.numpy(), auto.params.numpy(), rtol=1e-8)


def test_fit_takes_a_pytree_and_an_optimizer_factory():
    y = _y()
    params = {"kernel": torch.from_numpy(P0[:2]), "noise": torch.tensor(P0[2])}
    objective = _torch_objective(y)
    got = tt.fit(lambda p: objective(torch.cat([p["kernel"], p["noise"].reshape(1)])), params,
                 optimizer=lambda leaves: torch.optim.SGD(leaves, lr=1e-2), steps=3)
    assert set(got.params) == {"kernel", "noise"}
    assert got.params["kernel"].shape == (2,) and got.params["noise"].shape == ()
    assert got.losses[-1] < got.losses[0]
    assert torch.equal(params["kernel"], torch.from_numpy(P0[:2]))  # the start is not touched


def test_fit_lbfgs_reaches_the_reference_optimum():
    y = _y()
    ref = jlearning.fit_lbfgs(_jax_objective(y), jnp.asarray(P0), steps=40)
    got = tt.fit_lbfgs(_torch_objective(y), torch.from_numpy(P0), steps=40)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params), atol=1e-4)
    np.testing.assert_allclose(got.losses[-1].item(), float(ref.losses[-1]), rtol=1e-8)


def test_value_and_grad_fwd_matches_reference_on_a_pytree():
    y = _y()
    j_obj, t_obj = _jax_objective(y), _torch_objective(y)
    v_ref, g_ref = jlearning.value_and_grad_fwd(
        lambda p: j_obj(jnp.concatenate([p["kernel"], p["noise"][None]])))(
            {"kernel": jnp.asarray(P0[:2]), "noise": jnp.asarray(P0[2])})
    value, grad = tt.value_and_grad_fwd(
        lambda p: t_obj(torch.cat([p["kernel"], p["noise"].reshape(1)])))(
            {"kernel": torch.from_numpy(P0[:2]), "noise": torch.tensor(P0[2])})
    np.testing.assert_allclose(value.item(), float(v_ref), rtol=1e-10)
    np.testing.assert_allclose(grad["kernel"].numpy(), np.asarray(g_ref["kernel"]), rtol=1e-8)
    np.testing.assert_allclose(grad["noise"].item(), float(g_ref["noise"]), rtol=1e-8)


def test_positive_and_constrained_match_reference():
    x = np.array([0.5, 2.0, 7.0])
    log_x = tt.positive(x, device="cpu")
    assert log_x.dtype == torch.float64
    np.testing.assert_allclose(log_x.numpy(), np.asarray(jlearning.positive(x)), rtol=1e-15)
    np.testing.assert_allclose(tt.constrained(log_x).numpy(), x, rtol=1e-15)


def test_value_and_grad_fisher_names_what_it_waits_for():
    """value_and_grad_fisher runs (tests/test_torch_fisher.py); on an engine
    that has no filter and posterior LGSSM (engine="lti", whose filter the
    reference has neither) it raises, naming the engine."""
    vg = learning.value_and_grad_fisher(lambda p: build_lgssm(_torch_fx(p)), _y(), engine="lti")
    with pytest.raises(ValueError, match="'lti'"):
        vg(torch.from_numpy(P0))


def test_default_device_is_the_card():
    """Building an LTISDE allocates nothing, so this runs without a card."""
    assert to_sde(GP(Matern52())).device.type == "cuda"
    assert LTISDE(GP(Matern52())).device.type == "cuda"
    assert to_sde(GP(Matern52()), device="cpu").device.type == "cpu"


@pytest.mark.parametrize(
    "build",
    [
        lambda: to_sde(GP(Matern52()))(tt.RegularSpacing(0.0, 0.1, 8), 0.1),
        lambda: kernels.sde_atoms(Matern52()),
        lambda: convert.lgssm_from_numpy(
            np.eye(1), np.zeros(1), np.eye(1), np.ones(1), 0.0, 0.1, np.zeros(1), np.eye(1), 8,
            dtype=torch.float64),
        lambda: tt.positive([0.5, 2.0]),
    ],
    ids=["to_sde", "sde_atoms", "lgssm_from_numpy", "positive"],
)
def test_default_device_does_not_fall_back_to_the_cpu(build):
    """Without a card the default surfaces PyTorch's own error; with one, the
    tensors lie on it."""
    if torch.cuda.is_available():
        built = build()
        tensor = built if torch.is_tensor(built) else (
            built.noise.value if hasattr(built, "noise") else (
                built.P_inf if hasattr(built, "P_inf") else built.trans.x0.mean))
        assert tensor.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
            build()
