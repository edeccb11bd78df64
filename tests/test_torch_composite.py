"""Composite models in the port (temporalgps_torch: Sum, Product, CustomMean,
block_diag, lgssm_components, gp.dense, and logpdf, marginals and the
forward-mode gradient of composite models) against the reference package on
the CPU, float64. The models and inputs are tests/torch_composite_cases.py's.
Tolerances: 1e-10 relative for the compiled leaves, 1e-12 for grams and the
dense oracle (the same formulas); 1e-9 for logpdf and marginals (another
association of the same recursions); 1e-8 for the gradient (two autodiff
systems through the same recursions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu.gp import dense as jdense
from temporalgps_tpu.gp import kernels as jkernels
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from torch_composite_cases import (JRegularSpacing, KERNELS, N, NOISE, TIMES, close, fxs,
                                   jitted, leaves, make_y, reference_posterior, value)

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.utils import psd
from temporalgps_torch.utils.fill import is_fill

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# Kernels, compiler, dense oracle
# ---------------------------------------------------------------------------

CASES = [("sum3", False, False), ("sum3", True, True), ("prod2", False, True),
         ("prod2", True, False), ("sum5", False, False), ("sum5", True, True)]
CASE_IDS = [f"{n}-{'irregular' if i else 'regular'}-{'custom_mean' if c else 'zero'}"
            for n, i, c in CASES]


@pytest.mark.parametrize("name,irregular,custom_mean", CASES, ids=CASE_IDS)
def test_lgssm_components_match_reference(name, irregular, custom_mean):
    """The compiled leaves, Fill or per step as in the reference: a Sum's
    block-diagonal A, Q and x0 covariance, concatenated H, summed h; a
    Product's Kronecker atoms; a CustomMean's per-step h."""
    jfx, tfx = fxs(name, irregular, custom_mean)
    jmodel, tmodel = japi.build_lgssm(jfx), tgp.build_lgssm(tfx)
    assert tmodel.latent_dim == jkernels.state_dim(KERNELS[name](jgp))
    assert tmodel.latent_dim == tgp.kernels.state_dim(KERNELS[name](tgp))
    for got, want in zip(leaves(tmodel), leaves(jmodel)):
        assert is_fill(got) == hasattr(want, "value")
        close(value(got), value(want), rtol=1e-10)
    close(tmodel.trans.x0.mean, jmodel.trans.x0.mean, rtol=1e-10)
    close(tmodel.trans.x0.cov, jmodel.trans.x0.cov, rtol=1e-10)
    tcomp = tgp.lgssm_components(KERNELS[name](tgp), tfx.x, torch.float64, "cpu")
    close(value(tcomp[0]), value(jmodel.trans.As), rtol=1e-10)


def test_combine_leaves_mixes_fill_and_per_step_children():
    """A Fill child beside a per-step one gives per-step leaves (a Sum of a
    RegularSpacing-like child and an irregular one, as irregular times with
    different stretches give)."""
    from temporalgps_torch.gp.lti_sde import _combine_leaves
    from temporalgps_torch.utils.fill import Fill

    rng = np.random.default_rng(3)
    A1, A2 = torch.as_tensor(rng.standard_normal((2, 2))), torch.as_tensor(
        rng.standard_normal((N, 1, 1)))
    out = _combine_leaves(lambda *ms: psd.block_diag(list(ms)), [Fill(A1, N), A2], N)
    assert out.shape == (N, 3, 3)
    want = jnp.stack([jax.scipy.linalg.block_diag(np.asarray(A1), np.asarray(A2[n]))
                      for n in range(N)])
    close(out, want, rtol=0)
    both = _combine_leaves(lambda *ms: psd.block_diag(list(ms)), [Fill(A1, N), Fill(A1, N)], N)
    assert is_fill(both) and both.value.shape == (4, 4)


@pytest.mark.parametrize("name", list(KERNELS))
def test_grams_and_sde_matrices_match_reference(name):
    """gram (on the times, and between two sets), gram_diag and
    to_sde_matrices (a Sum's direct sum, a Product's Kronecker sum)."""
    jk, tk = KERNELS[name](jgp), KERNELS[name](tgp)
    t = torch.as_tensor(TIMES)
    close(tgp.kernels.gram(tk, t), jkernels.gram(jk, jnp.asarray(TIMES)), rtol=1e-12)
    close(tgp.kernels.gram(tk, t[:7], t[3:]),
           jkernels.gram(jk, jnp.asarray(TIMES[:7]), jnp.asarray(TIMES[3:])), rtol=1e-12)
    close(tgp.kernels.gram_diag(tk, t), jkernels.gram_diag(jk, jnp.asarray(TIMES)),
           rtol=1e-12)
    F, q, H = tgp.kernels.to_sde_matrices(tk, device="cpu")
    F_ref, q_ref, H_ref = jkernels.to_sde_matrices(jk)
    close(F, F_ref, rtol=1e-12)
    close(H, H_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(q, dtype=float), np.asarray(q_ref, dtype=float),
                               rtol=1e-12)


def _dense_ref(jfx, y):
    return (*jdense.dense_mean_cov(jfx), jdense.dense_logpdf(jfx, y),
            *jdense.dense_marginals(jfx), japi.cov(jfx))


def test_dense_oracle_matches_reference():
    """gp.dense on the sum3 kernel with the mean function: dense_mean_cov,
    dense_logpdf, dense_marginals and the prior cov against the reference's
    (one jitted call)."""
    jfx, tfx = fxs("sum3", irregular=True, custom_mean=True)
    y = make_y(nan_at=())
    got = (*tgp.dense.dense_mean_cov(tfx), tgp.dense.dense_logpdf(tfx, y),
           *tgp.dense.dense_marginals(tfx), tgp.cov(tfx))
    for g, w in zip(got, jitted(_dense_ref)(jfx, jnp.asarray(y))):
        close(g, w, rtol=1e-12)


def test_product_sde_atoms_and_sum_refusal():
    """sde_atoms of a Product is the Kronecker product of its children's
    (P_inf, H, transition); of a Sum it raises TypeError, as the
    reference's: sums compose one level up."""
    jk, tk = KERNELS["prod2"](jgp), KERNELS["prod2"](tgp)
    ja, ta = jkernels.sde_atoms(jk), tgp.kernels.sde_atoms(tk, device="cpu")
    close(ta.P_inf, ja.P_inf, rtol=1e-12)
    close(ta.H, ja.H, rtol=1e-12)
    dts = np.array([0.0, 0.1, 1.7])
    close(ta.transition(torch.as_tensor(dts)), ja.transition(jnp.asarray(dts)), rtol=1e-12)
    with pytest.raises(TypeError, match="lgssm_components"):
        tgp.kernels.sde_atoms(KERNELS["sum3"](tgp), device="cpu")


# ---------------------------------------------------------------------------
# logpdf, marginals, gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,irregular,custom_mean", [CASES[i] for i in (0, 1, 5)],
                         ids=[CASE_IDS[i] for i in (0, 1, 5)])
def test_logpdf_and_marginals_match_reference(name, irregular, custom_mean):
    """logpdf with NaNs on both port engines (sequential; block: the plain
    schedule, K1-K3's plain versions or the lane path for D <= 3, the matrix
    path for D = 5, and the fused Function over the wrappers' plain
    versions) against the reference's sequential engine; the prior marginals
    likewise; the posterior marginals at the training inputs against the
    reference's sequential engine on both port engines (for D = 5 the
    port's matrix path inverts without the reference block engine's jitter,
    which moves that engine ~4e-9 from the sequential value)."""
    jfx, tfx = fxs(name, irregular, custom_mean)
    y = make_y()
    want = float(jitted(japi.logpdf, engine="sequential")(jfx, jnp.asarray(y)))
    for kwargs in ({"engine": "sequential"}, {"engine": "block", "fused": False},
                   {"engine": "block", "fused": True}):
        np.testing.assert_allclose(tt.logpdf(tfx, y, **kwargs).item(), want, rtol=1e-9)
    m_ref, v_ref = jitted(japi.marginals, engine="sequential")(jfx)
    for engine in ("sequential", "block"):
        m, v = tt.marginals(tfx, engine=engine)
        close(m, m_ref)
        close(v, v_ref)
    fxp = tpost.posterior(tfx, y)(tfx.x, 0.2)
    ref = _posterior_marginals_ref(name, "sequential", irregular, custom_mean)
    for engine in ("sequential", "block"):
        for got, want in zip(tpost.marginals(fxp, engine=engine), ref):
            close(got, want)


def _posterior_marginals_ref(name, engine, irregular, custom_mean):
    """The reference's posterior marginals at the training inputs, noise 0.2,
    of `_reference_posterior` (its gp.posterior.marginals, stage by
    stage)."""
    post = reference_posterior(name, engine, irregular, custom_mean)[1]
    post = jmissings.replace_observation_noise_cov(post, jnp.full((N,), 0.2))
    return jitted(jlgssm.marginals_diag, engine="sequential")(post)


def test_value_and_grad_fwd_lgssm_of_a_sum_matches_reference():
    """k = 5 (both scales, both stretches, the noise) of the sum3 kernel on
    RegularSpacing: K4-K6's plain versions here, against the reference's
    forward-mode gradient (jax.jacfwd of its sequential logpdf)."""
    y = make_y()
    p0 = np.array([np.log(0.5), np.log(2.0), 0.0, np.log(0.5), np.log(NOISE)])

    def build(gp, exp, p):
        s1, st1, s2, st2, noise = exp(p)
        return (s1 * gp.Matern12()).stretch(st1) + (s2 * gp.Matern32()).stretch(st2), noise

    def jax_lml(p):
        k, noise = build(jgp, jnp.exp, p)
        return japi.logpdf(jgp.to_sde(jgp.GP(k))(JRegularSpacing(0.0, 0.1, N), noise),
                           jnp.asarray(y), engine="sequential")

    def model_fn(p):
        k, noise = build(tgp, torch.exp, p)
        return tgp.build_lgssm(tgp.to_sde(tgp.GP(k), device="cpu")(
            tt.RegularSpacing(0.0, 0.1, N), noise))

    g_ref = jax.jit(jax.jacfwd(jax_lml))(jnp.asarray(p0))
    model, tangents = tt.learning._model_and_tangents(model_fn, torch.as_tensor(p0))
    assert tt.ops.block._fwd_grad_supported(model, tangents) and len(tangents) == 5
    v, g = tt.value_and_grad_fwd_lgssm(model_fn, y)(torch.as_tensor(p0))
    np.testing.assert_allclose(v.item(), float(jax_lml(jnp.asarray(p0))), rtol=1e-9)
    close(g, g_ref, rtol=1e-8)


def test_mean_and_kernel_specs_carry_across():
    """convert.kernel_from_spec builds Sum and Product, mean_from_spec the
    constant means; the carried model equals the one built in the port."""
    spec = ("Sum", (("Stretched", ("Scaled", ("Matern12",), np.float64(0.5)), np.float64(2.0)),
                    ("Product", (("Matern12",), ("Matern32",)))))
    k = convert.kernel_from_spec(spec)
    assert isinstance(k, tgp.Sum) and isinstance(k.kernels[1], tgp.Product)
    mean = convert.mean_from_spec(("ConstMean", np.float64(0.3)))
    assert isinstance(convert.mean_from_spec(("ZeroMean",)), tgp.ZeroMean)
    fx = tgp.to_sde(tgp.GP(k, mean), device="cpu")(tt.RegularSpacing(0.0, 0.1, N), NOISE)
    want = tgp.to_sde(tgp.GP(0.5 * tgp.Matern12().stretch(2.0)
                             + tgp.Matern12() * tgp.Matern32(), tgp.ConstMean(0.3)),
                      device="cpu")(tt.RegularSpacing(0.0, 0.1, N), NOISE)
    for a, b in zip(leaves(tgp.build_lgssm(fx)), leaves(tgp.build_lgssm(want))):
        assert np.array_equal(value(a), value(b))
