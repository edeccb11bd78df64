"""Sampling and the posterior's scores in the port (temporalgps_torch:
rand, rand_with_eps on both engines and orderings, the reverse-ordered
logpdf, gp.posterior.rand and logpdf) against the reference package on the
CPU, float64. The models and inputs are tests/torch_composite_cases.py's.
The normals of a sample are drawn with jax.random as the reference's
`lgssm.rand` draws them (split(key, 3), then the initial state, eps_t and
eps_e) and handed to both packages: torch's and JAX's generators differ.
Tolerances: 1e-10 relative for samples of one set of normals (the same
algebra); 1e-9 for logpdf (another association of the same recursions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.gp import posterior as jpost
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock
from temporalgps_tpu.utils.gaussian import gaussian_rand as jgaussian_rand
from torch_composite_cases import (B, KERNELS, N, TIMES, close, fxs, jitted, make_y,
                                   reference_posterior)

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _reference_eps(jmodel, seed):
    """(x_init, eps_t, eps_e) as the reference's lgssm.rand draws them."""
    k0, kt, ke = jax.random.split(jax.random.PRNGKey(seed), 3)
    x_init = jgaussian_rand(k0, jmodel.trans.x0)
    return (x_init, jax.random.normal(kt, (N, jmodel.latent_dim), jnp.float64),
            jax.random.normal(ke, (N,), jnp.float64))


@pytest.mark.parametrize("name,forward", [("sum3", True), ("sum3", False), ("sum5", True),
                                          ("sum5", False)],
                         ids=["sum3-prior", "sum3-posterior", "sum5-prior", "sum5-posterior"])
def test_rand_with_eps_matches_reference(name, forward):
    """The port's rand_with_eps on both engines (sequential; block: K8-K10's
    plain versions for D = 3, the matrix affine prefix for D = 5) and both
    orderings (the prior; the reference's posterior, reverse-ordered,
    carried across) on the normals the reference's lgssm.rand draws from a
    key: against the reference's block.rand_with_eps on them (D = 3) and its
    lgssm.rand on that key (both D)."""
    jmodel, jpost_model, tmodel, tpost_model = reference_posterior(name)
    jm, tm = (jmodel, tmodel) if forward else (jpost_model, tpost_model)
    x_init, eps_t, eps_e = _reference_eps(jm, seed=7)
    want = jitted(jlgssm.rand, engine="sequential")(jax.random.PRNGKey(7), jm)
    if name == "sum3":
        close(jitted(jblock.rand_with_eps, n_blocks=B)(jm, eps_t, eps_e, x_init), want,
               rtol=1e-10)
    args = [torch.as_tensor(np.array(a)) for a in (eps_t, eps_e, x_init)]
    for engine in ("sequential", "block"):
        close(tlgssm.rand_with_eps(tm, *args, engine=engine, n_blocks=B), want, rtol=1e-10)


def test_public_rand_shape_seed_and_draws():
    """gp.rand on a Sum with a CustomMean: one seeded torch.Generator gives
    the same draws on both engines, `n` stacks draws, and the sample mean
    and variance of many draws approach the prior marginals."""
    _, tfx = fxs("sum3", irregular=True, custom_mean=True)
    draw = lambda seed, **kw: tt.rand(torch.Generator().manual_seed(seed), tfx, **kw)
    one = draw(3)
    assert one.shape == (N,) and one.dtype == torch.float64
    assert torch.equal(one, draw(3))
    close(draw(3, engine="block"), one, rtol=1e-10)
    assert not torch.equal(one, draw(4))
    many = draw(5, n=60, engine="block")
    assert many.shape == (60, N)
    m, v = tt.marginals(tfx)
    assert (many.mean(0) - m).abs().max() < 4 * (v / 60).sqrt().max()
    assert ((many.var(0) / v) - 1).abs().max() < 0.6


# ---------------------------------------------------------------------------
# The reverse-ordered logpdf and the posterior's logpdf and rand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sum3", "sum5"])
def test_reverse_ordered_logpdf_matches_reference(name):
    """The reference's posterior LGSSM (reverse-ordered, per-step leaves)
    scored on y with NaN at its first and last step: sequential (emit, then
    transition); the block engine through the iteration view (the lane path
    and the streamed wrappers' plain versions for D = 3, the matrix path for
    D = 5) against the reference's sequential engine. filter_ of the view
    gives the sequential engine's filtering states."""
    _, jpost_model, _, tpost_model = reference_posterior(name)
    y = make_y(seed=4, nan_at=(0, 9, N - 1))
    want = float(jitted(jmissings.logpdf_with_missings, engine="sequential")(
        jpost_model, jnp.asarray(y)))
    yt = torch.as_tensor(y)
    for kwargs in ({"engine": "sequential"}, {"engine": "block", "fused": False},
                   {"engine": "block", "fused": True, "n_blocks": B}):
        np.testing.assert_allclose(
            tmissings.logpdf_with_missings(tpost_model, yt, **kwargs).item(), want, rtol=1e-9)
    model_f, y_f, _ = tmissings.transform_model_and_obs(tpost_model, yt)
    xs = tlgssm.filter_(model_f, y_f, engine="sequential")
    xb = tlgssm.filter_(model_f, y_f, engine="block", n_blocks=B)
    close(xb.mean, xs.mean)
    close(xb.cov, xs.cov)


def _merged_posterior_ref(jfxp):
    """(the reference's posterior LGSSM over the merged times, the
    prediction indices): its gp.posterior stages, jitted."""
    x_sorted, noise_all, y_all, _, pr_idx = jpost._build_inference_data(jfxp.f, jfxp.x)
    noise_pred = jpost._pred_noise_full(pr_idx, len(x_sorted), jfxp.noise, jnp.float64)
    post = jitted(jmissings.posterior_with_missings, engine="sequential")(
        jitted(japi.build_lgssm)(jfxp.f.prior(x_sorted, noise_all)), y_all)
    return jmissings.replace_observation_noise_cov(post, noise_pred), pr_idx


def _new_times(seed=5):
    """N new times over and beyond the training span: the merged model then
    has as many steps as at the training inputs, and the reference's jit of
    it serves both."""
    return np.sort(np.random.default_rng(seed).uniform(TIMES[0] - 0.3, TIMES[-1] + 0.3, N))


@pytest.mark.parametrize("at", ["training", "new"])
def test_posterior_logpdf_matches_reference(at):
    """gp.posterior.logpdf of a Sum with a CustomMean on irregular times, at
    the training inputs (merged with themselves) and at new times, against
    the reference's, on both port engines."""
    jfx, tfx = fxs("sum3", irregular=True, custom_mean=True)
    y = make_y()
    x_pr = TIMES if at == "training" else _new_times()
    y_pr = np.random.default_rng(6).standard_normal(len(x_pr))
    jfxp = jpost.posterior(jfx, jnp.asarray(y))(jnp.asarray(x_pr), 0.2)
    jpost_model, pr_idx = _merged_posterior_ref(jfxp)
    y_full = np.full(len(jpost_model.trans.As), np.nan)
    y_full[pr_idx] = y_pr
    want = float(jitted(jmissings.logpdf_with_missings, engine="sequential")(
        jpost_model, jnp.asarray(y_full)))
    fxp = tpost.posterior(tfx, y)(torch.as_tensor(x_pr), 0.2)
    for engine in ("sequential", "block"):
        np.testing.assert_allclose(tpost.logpdf(fxp, y_pr, engine=engine).item(), want,
                                   rtol=1e-9)


def test_posterior_rand_matches_reference_on_the_same_eps():
    """gp.posterior.rand at new times: the merged posterior LGSSM of both
    packages sampled on the same normals (the port on both engines), read
    out at the prediction indices; and the public call's shape and seed."""
    jfx, tfx = fxs("sum3", irregular=True, custom_mean=True)
    y = make_y()
    x_pr = _new_times()
    jfxp = jpost.posterior(jfx, jnp.asarray(y))(jnp.asarray(x_pr), 0.2)
    fxp = tpost.posterior(tfx, y)(torch.as_tensor(x_pr), 0.2)
    jpost_model, pr_idx = _merged_posterior_ref(jfxp)
    tpost_model, idx = tpost._merged_posterior(fxp, "sequential")
    assert np.array_equal(idx.numpy(), pr_idx)
    k0, kt, ke = jax.random.split(jax.random.PRNGKey(11), 3)
    n = len(pr_idx) + N
    x_init = jgaussian_rand(k0, jpost_model.trans.x0)
    eps_t = jax.random.normal(kt, (n, jpost_model.latent_dim), jnp.float64)
    eps_e = jax.random.normal(ke, (n,), jnp.float64)
    want = np.asarray(jitted(jlgssm.rand, engine="sequential")(
        jax.random.PRNGKey(11), jpost_model))[pr_idx]
    args = [torch.as_tensor(np.array(a)) for a in (eps_t, eps_e, x_init)]
    for engine in ("sequential", "block"):
        close(tlgssm.rand_with_eps(tpost_model, *args, engine=engine)[idx], want, rtol=1e-10)
    draw = tpost.rand(torch.Generator().manual_seed(2), fxp)
    assert draw.shape == (len(x_pr),)
    assert torch.equal(draw, tpost.rand(torch.Generator().manual_seed(2), fxp))


@pytest.mark.parametrize("engine", ["sequential", "block"])
def test_float32_posterior_sample_holds_to_float64(engine):
    """The posterior of a Sum at its training inputs on dt = 1e-3 (merged
    with themselves: steps of dt = 0, where the reverse model's Q is a
    difference of equal covariances) sampled in float32 and in float64 on
    the same normals: each engine inverts the dynamics in float64, so the
    float32 reverse model's Q stays positive definite and its sample is
    within 1e-3 of the float64 one, relative to the largest value."""
    n = 500
    y = np.random.default_rng(3).standard_normal(n)
    y[7] = np.nan
    rng = np.random.default_rng(12)
    eps = [rng.standard_normal((2 * n, 3)), rng.standard_normal(2 * n), rng.standard_normal(3)]
    out = {}
    for dtype in (torch.float32, torch.float64):
        fx = tgp.to_sde(tgp.GP(KERNELS["sum3"](tgp)), tgp.ArrayStorage(dtype), device="cpu")(
            tt.RegularSpacing(0.0, 1e-3, n), 0.1)
        post, idx = tpost._merged_posterior(tpost.posterior(fx, y)(fx.x, 0.1), engine)
        assert len(post) == 2 * n and post.dtype == dtype
        assert torch.linalg.eigvalsh(post.trans.Qs.double())[:, 0].min() > 0
        out[dtype] = tlgssm.rand_with_eps(post, *(torch.as_tensor(e, dtype=dtype) for e in eps),
                                          engine=engine)[idx]
    want = out[torch.float64]
    close(out[torch.float32].double(), want, rtol=1e-3)
