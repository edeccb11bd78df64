"""The port's associative engine (temporalgps_torch/ops/assoc.py,
engine="parallel"), the block posterior of a reverse-ordered model that it
serves, and the matrix path's inverse that it holds, against the reference
package (temporalgps_tpu/ops/assoc.py, ops/block.py) on the CPU in float64.

Models are tests/torch_composite_cases.py's sum3 (D = 3) on N = 40 regular or
irregular times, forward-ordered (the prior) or reverse-ordered (the
reference's posterior, carried across), the NaNs of y at the first and last
step filled as both packages' missing-data machinery fills them. Tolerance
1e-10 relative to the largest entry: the same element algebra in the same
association (jax.lax.associative_scan's).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalgps_tpu import RegularSpacing as JRegularSpacing
import temporalgps_tpu.gp as jgp
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import assoc as jassoc
from temporalgps_tpu.ops import block as jblock
from temporalgps_tpu.utils.gaussian import gaussian_rand as jgaussian_rand
from torch_composite_cases import N, carry, close, fxs, jitted, make_y, reference_posterior

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.ops import assoc, block

torch.set_num_threads(1)

ENDS = (0, N - 1)  # the NaNs of y: the first and the last step


@functools.cache
def _case(forward, irregular):
    """(reference model, its filled y, port model, port y): sum3's prior, or
    its posterior (reverse-ordered) scoring another y."""
    if forward:
        jm = japi.build_lgssm(fxs("sum3", irregular)[0])
    else:
        jm = reference_posterior("sum3", irregular=irregular, custom_mean=False)[1]
    y = make_y(seed=2 if forward else 3, nan_at=ENDS)
    jm_f, jy, _ = jmissings.transform_model_and_obs(jm, jnp.asarray(y))
    return jm_f, jy, carry(jm_f, forward), torch.as_tensor(np.asarray(jy))


def _reference_eps(jmodel, seed):
    k0, kt, ke = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jgaussian_rand(k0, jmodel.trans.x0),
            jax.random.normal(kt, (N, jmodel.latent_dim), jnp.float64),
            jax.random.normal(ke, (N,), jnp.float64))


def _close_model(got, want):
    for g, w in ((got.trans.As, want.trans.As), (got.trans.offs, want.trans.offs),
                 (got.trans.Qs, want.trans.Qs), (got.trans.x0.mean, want.trans.x0.mean),
                 (got.trans.x0.cov, want.trans.x0.cov)):
        close(g, w, rtol=1e-10)
    assert got.trans.forward == want.trans.forward


@pytest.mark.parametrize("irregular", [False, True], ids=["regular", "irregular"])
@pytest.mark.parametrize("forward", [True, False], ids=["forward", "reverse"])
def test_parallel_engine_matches_reference(forward, irregular):
    """Through models.lgssm with engine="parallel": logpdf, filter_, the
    latent marginals and the observation marginals, the posterior's leaves
    and its latent marginals, and rand_with_eps on the reference's
    normals."""
    jm, jy, tm, ty = _case(forward, irregular)
    close(tlgssm.logpdf(tm, ty, engine="parallel").reshape(1),
          np.reshape(jitted(jassoc.logpdf)(jm, jy), 1), rtol=1e-10)
    xf, xf_ref = tlgssm.filter_(tm, ty, engine="parallel"), jitted(jassoc.filter_)(jm, jy)
    close(xf.mean, xf_ref.mean, rtol=1e-10)
    close(xf.cov, xf_ref.cov, rtol=1e-10)
    lat, lat_ref = tlgssm.latent_marginals(tm, engine="parallel"), jitted(jassoc.latent_marginals)(jm)
    close(lat.mean, lat_ref.mean, rtol=1e-10)
    close(lat.cov, lat_ref.cov, rtol=1e-10)
    for got, want in zip(tlgssm.marginals_diag(tm, engine="parallel"),
                         jitted(jlgssm.marginals_diag, engine="parallel")(jm)):
        close(got, want, rtol=1e-10)
    post, post_ref = tlgssm.posterior(tm, ty, engine="parallel"), jitted(jassoc.posterior)(jm, jy)
    _close_model(post, post_ref)
    lat, lat_ref = tlgssm.latent_marginals(post, engine="parallel"), jitted(jassoc.latent_marginals)(
        post_ref)
    close(lat.mean, lat_ref.mean, rtol=1e-10)
    close(lat.cov, lat_ref.cov, rtol=1e-10)
    x_init, eps_t, eps_e = _reference_eps(jm, seed=11)
    want = jitted(jassoc.rand_with_eps)(jm, eps_t, eps_e, x_init)
    got = tlgssm.rand_with_eps(tm, *(torch.as_tensor(np.asarray(a)) for a in (eps_t, eps_e, x_init)),
                               engine="parallel")
    close(got, want, rtol=1e-10)


def test_block_posterior_of_a_reverse_model_matches_reference():
    """block.posterior of a reverse-ordered model (the reference's block
    engine hands it to its associative one), through models.lgssm, against
    the reference's block.posterior; the block engine's filter of it (its
    iteration view's forward model) beside."""
    jm, jy, tm, ty = _case(False, True)
    post = tlgssm.posterior(tm, ty, engine="block")
    _close_model(post, jitted(jblock.posterior)(jm, jy))
    assert post.trans.forward
    xf = block.filter_(tm, ty)
    xf_ref = jitted(jassoc.filter_)(jm, jy)
    close(xf.mean, xf_ref.mean, rtol=1e-10)
    close(xf.cov, xf_ref.cov, rtol=1e-10)


# ---------------------------------------------------------------------------
# The matrix path's inverse (D > 3): no jitter
# ---------------------------------------------------------------------------

N_D5 = 2000


@functools.cache
def _d5_reference():
    """The reference's float64 sequential posterior means of Matern52() +
    Matern32() at its training inputs, RegularSpacing(0, 1e-3, 2000), noise
    0.1, one NaN; and y."""
    y = np.random.default_rng(0).standard_normal(N_D5)
    y[N_D5 // 3] = np.nan
    jfx = jgp.to_sde(jgp.GP(jgp.Matern52() + jgp.Matern32()))(
        JRegularSpacing(0.0, 1e-3, N_D5), 0.1)
    jmodel = japi.build_lgssm(jfx)
    post = jitted(jmissings.posterior_with_missings, engine="sequential")(jmodel, jnp.asarray(y))
    post = jmissings.replace_observation_noise_cov(post, jnp.full((N_D5,), 0.1))
    return np.asarray(jitted(jlgssm.marginals_diag, engine="sequential")(post)[0]), y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_matrix_path_posterior_means_match_reference_sequential(dtype):
    """The D = 5 sum on the block engine's matrix path (its combines invert
    I + C J without a jitter): the posterior means at the training inputs
    against the reference's float64 sequential engine, relative to the
    largest entry; float64 within 1e-10, float32 within 1e-3 and no further
    than the port's float32 sequential engine (the reference's jittered
    inverse left 7.7e-2 here)."""
    want, y = _d5_reference()
    fx = tgp.to_sde(tgp.GP(tgp.Matern52() + tgp.Matern32()), tgp.ArrayStorage(dtype),
                    device="cpu")(tt.RegularSpacing(0.0, 1e-3, N_D5), 0.1)
    assert not block._streamed_supported(tgp.build_lgssm(fx))

    def means(engine):
        m = tpost.marginals(tpost.posterior(fx, y)(fx.x, 0.1), engine=engine)[0]
        return np.abs(m.double().numpy() - want).max() / np.abs(want).max()

    r_block = means("block")
    if dtype == torch.float64:
        assert r_block <= 1e-10, r_block
    else:
        r_seq = means("sequential")
        assert r_block <= min(1e-3, r_seq), (r_block, r_seq)


def test_minv_is_the_plain_inverse():
    """assoc._minv at D = 5 is (I + C J)^{-1} without a jitter, also where
    C is singular (the prior element's zero covariance legs)."""
    rng = np.random.default_rng(4)
    G = rng.standard_normal((3, 5, 2))
    C = torch.as_tensor(G @ G.transpose(0, 2, 1))  # rank 2: singular
    W = rng.standard_normal((3, 5, 5))
    J = torch.as_tensor(W @ W.transpose(0, 2, 1))
    M = assoc._minv(C, J)
    close(M @ (torch.eye(5, dtype=torch.float64) + C @ J), np.broadcast_to(np.eye(5), (3, 5, 5)),
          rtol=1e-12)
