"""The deterministic kernels in the port (temporalgps_torch.gp.kernels:
Cosine, Constant, ApproxPeriodic; their SDEs, grams, the float32 process
noise floor, the det_blocks flag) against the reference package and the
dense oracle on the CPU, float64. Mirrors tests/test_lti_sde.py's cases for
these kernels. Tolerances: the reference's own against the dense oracle
(1e-7 relative, its Bessel-truncated ApproxPeriodic 2e-6 at small r);
1e-10 against the reference's state-space results (the same recursions);
1e-9 for the block engine against the reference's sequential one (another
association).
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
from temporalgps_tpu.gp import posterior as jpost

import temporalgps_torch as tt
import temporalgps_torch.gp as tgp
from temporalgps_torch import convert
from temporalgps_torch.gp import dense as tdense
from temporalgps_torch.gp import kernels as tkernels
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.ops import assoc, block, steady

torch.set_num_threads(1)

N = 13


def _close(actual, desired, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(actual).detach()),
                               np.asarray(desired), rtol=rtol, atol=atol)


# The same kernel in both packages: `m` is the package's gp module.
KERNELS = {
    "cosine": lambda m: m.Cosine(),
    "constant": lambda m: m.Constant(1.3),
    "approx-periodic": lambda m: m.ApproxPeriodic(1.0),
    "product-constant": lambda m: 3.0 * m.Matern32() * m.Matern52() * m.Constant(1.0),
    "sum3": lambda m: 2.0 * m.Matern32() + 0.5 * m.Matern52() + m.Constant(1.0),
}


def _inputs(irregular, seed=0):
    """(reference input, port input) times: regular or sorted uniform."""
    if irregular:
        xs = np.sort(np.random.default_rng(seed).uniform(0.0, 4.0, N))
        return xs, torch.as_tensor(xs)
    return JRegularSpacing(0.0, 0.3, N), tt.RegularSpacing(0.0, 0.3, N)


def _check_against_dense_and_reference(name_or_kernels, x_irregular, rtol=1e-7, seed=0,
                                      reference=True):
    jk, tk = name_or_kernels
    jx, tx = _inputs(x_irregular, seed)
    tfx = tgp.to_sde(tgp.GP(tk), device="cpu")(tx, 0.1)
    m, v = tt.marginals(tfx)
    m_dense, v_dense = tdense.dense_marginals(tfx)
    _close(m, m_dense, rtol, 1e-8)
    _close(v, v_dense, rtol, 1e-8)
    y = np.random.default_rng(seed + 1).standard_normal(N)
    lp = tt.logpdf(tfx, y)
    _close(lp, tdense.dense_logpdf(tfx, torch.as_tensor(y)), rtol, 1e-6)
    if not reference:
        return
    jfx = jgp.to_sde(jgp.GP(jk))(jx, 0.1)
    m_ref, v_ref = jax.jit(lambda: jgp.marginals(jfx))()
    _close(m, m_ref, 1e-10, 1e-12)
    _close(v, v_ref, 1e-10)
    # The reference's own basis engine inverts I + C J with a jitter (~1e-8
    # off); its sequential engine on the full model is the truth.
    _close(lp, japi.logpdf(jfx, jnp.asarray(y), engine="sequential"), 1e-10)


@pytest.mark.parametrize("name", list(KERNELS))
def test_sde_matches_dense_gram_and_reference(name):
    """Prior marginals and logpdf (engine=None: the basis engine for sum3,
    the sequential one otherwise, as in the reference) against the dense
    gram and the reference, on regular and irregular times."""
    for irregular in (False, True):
        _check_against_dense_and_reference((KERNELS[name](jgp), KERNELS[name](tgp)), irregular)


def test_approx_periodic_small_r_oracle():
    """r = 0.05 puts x = 1/(4 r^2) = 100 on the Bessel function's asymptotic
    branch; n_cos = 50 keeps the cosine series' truncation below the
    tolerance of the exact periodic gram. Against the dense oracle only, as
    the reference's test (its harmonics' series take ~75k traced ops)."""
    _check_against_dense_and_reference(
        (None, 0.7 * tgp.ApproxPeriodic(0.05, n_cos=50)), False, rtol=2e-6, reference=False)


def test_besseli_scaled_matches_scipy_and_its_gradient_is_finite():
    """e^-x I_n(x) on both branches against scipy.special.ive, and the
    gradient in x finite on both sides of the switch (each branch runs on a
    clamped argument)."""
    from scipy import special

    for n in [0, 1, 3, 6, 7, 10]:
        for x in [0.5, 5.0, 25.0, 29.9, 30.1, 50.0, 100.0, 1000.0, 1e4]:
            got = tkernels._besseli_scaled(n, torch.tensor(x, dtype=torch.float64))
            _close(got, special.ive(n, x), 1e-9)
    x = torch.tensor([0.5, 29.9, 30.1, 1e4], dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(tkernels._besseli_scaled(3, x).sum(), x)
    assert bool(torch.isfinite(g).all())


def test_det_blocks_flag_and_float32_noise_floor():
    """A kernel with a deterministic summand sets det_blocks; float32
    storage floors only its deterministic leaves' Q at 1e-5 P_inf (the
    reference's float32 Q, to float32 rounding); a Matern-only float32
    model stays unfloored; float64 keeps Q = 0 exactly."""
    K = tkernels
    assert K.has_deterministic_component(tgp.Cosine())
    assert K.has_deterministic_component(tgp.Matern52() + 0.3 * tgp.ApproxPeriodic(0.5))
    assert not K.has_deterministic_component(tgp.Matern52() + tgp.Matern52().stretch(2.0))

    def pair(kern, dtype, jdtype):
        jx = JRegularSpacing(jnp.asarray(0.0, jdtype), jnp.asarray(0.01, jdtype), 16)
        tx = tt.RegularSpacing(torch.tensor(0.0, dtype=dtype), torch.tensor(0.01, dtype=dtype), 16)
        jm = japi.build_lgssm(jgp.to_sde(jgp.GP(kern(jgp)), jgp.ArrayStorage(jdtype))(
            jx, jnp.asarray(0.1, jdtype)))
        tm = tgp.build_lgssm(tgp.to_sde(tgp.GP(kern(tgp)), tgp.ArrayStorage(dtype),
                                        device="cpu")(tx, 0.1))
        return jm, tm

    ksum = lambda m: m.Matern52() + 0.3 * m.ApproxPeriodic(0.5)
    jm, tm = pair(ksum, torch.float32, jnp.float32)
    assert tm.trans.det_blocks and jm.trans.det_blocks
    Q = tm.trans.Qs.value
    assert Q.dtype == torch.float32 and float(torch.diagonal(Q)[-1]) > 0
    _close(Q, jm.trans.Qs.value, 1e-6, 1e-12)
    jm, tm = pair(lambda m: m.Matern52(), torch.float32, jnp.float32)
    assert not tm.trans.det_blocks
    _close(tm.trans.Qs.value, jm.trans.Qs.value, 1e-6, 1e-12)
    _, tm64 = pair(lambda m: m.Matern52(), torch.float64, jnp.float64)
    _close(tm.trans.Qs.value, tm64.trans.Qs.value.float(), 1e-2)
    _, tm64 = pair(ksum, torch.float64, jnp.float64)
    assert tm64.trans.det_blocks and float(torch.diagonal(tm64.trans.Qs.value)[-1]) == 0.0


def test_det_blocks_carried_through_rebuilds():
    """Every model rebuilt from a det model keeps the flag: the posterior
    (reverse-ordered) of each engine, its forward view, steady._trim,
    assoc.widened, a space-time and a pseudo-point model of a Separable
    with a deterministic temporal part."""
    fx = tgp.to_sde(tgp.GP(tgp.Matern12() + 0.5 * tgp.Cosine().stretch(2.0)), device="cpu")(
        tt.RegularSpacing(0.0, 0.1, 40), 0.1)
    model = tgp.build_lgssm(fx)
    y = torch.as_tensor(np.random.default_rng(0).standard_normal(40))
    rebuilt = [steady._trim(model, 8), assoc.widened(model)]
    for engine in ("sequential", "block", "parallel", "lti"):
        post = tlgssm.posterior(model, y, engine=engine)
        rebuilt += [post, block._forward_view(post)[0]]
    rebuilt.append(tlgssm.posterior(rebuilt[2], y.flip(0), engine="block"))
    from temporalgps_torch.space_time import RectilinearGrid, Separable, dtcify

    grid = RectilinearGrid(torch.linspace(-1.0, 1.0, 3, dtype=torch.float64),
                           tt.RegularSpacing(0.0, 0.1, 5))
    sep = Separable(tgp.EQ(), tgp.Matern52() + tgp.Cosine())
    rebuilt.append(tgp.build_lgssm(tgp.to_sde(tgp.GP(sep), device="cpu")(grid, 0.1)))
    z = torch.linspace(-1.0, 1.0, 2, dtype=torch.float64)
    rebuilt.append(tgp.build_lgssm(dtcify(z, tgp.to_sde(tgp.GP(sep), device="cpu")(grid, 0.1))))
    assert all(m.trans.det_blocks for m in rebuilt)
    assert not tgp.build_lgssm(tgp.to_sde(tgp.GP(Separable(tgp.EQ(), tgp.Matern52())),
                                          device="cpu")(grid, 0.1)).trans.det_blocks


def test_to_sde_matrices_generate_closed_form_transitions():
    """expm(F dt) reproduces the closed-form transitions of sde_atoms for
    leaf and composite kernels, as the reference's test: the Cosine, the
    ApproxPeriodic and a Sum with one; (F, q, H) equal to the reference's."""
    import scipy.linalg as sla

    dt = 0.37
    cases = [
        lambda m: m.Cosine(),
        lambda m: (0.7 * m.Matern32()).stretch(1.3),
        lambda m: m.ApproxPeriodic(0.8, n_cos=4),
        lambda m: m.Matern32() * m.Matern12(),
        lambda m: m.Matern32() + m.ApproxPeriodic(0.9, n_cos=3),
        lambda m: m.Constant(0.5) * m.Cosine(),
    ]
    for case in cases:
        k = case(tgp)
        F, q, H = tkernels.to_sde_matrices(k, device="cpu")
        jF, jq, jH = jkernels.to_sde_matrices(case(jgp))
        _close(F, jF, 1e-14, 1e-14)
        _close(H, jH, 1e-14)
        np.testing.assert_allclose(np.asarray(q, dtype=float), np.asarray(jq, dtype=float))
        children = k.kernels if isinstance(k, tkernels.Sum) else (k,)
        A_closed = sla.block_diag(*[
            tkernels.sde_atoms(c, torch.float64, "cpu").transition(
                torch.tensor(dt, dtype=torch.float64)).numpy()
            for c in children])
        np.testing.assert_allclose(sla.expm(F.numpy() * dt), A_closed, atol=1e-12)
        assert H.shape == (F.shape[0],) == (tkernels.state_dim(k),)


def test_kernel_from_spec_builds_the_new_kernels():
    """("Cosine",), ("Constant", c), ("ApproxPeriodic", r, n_cos) give the
    reference's kernel: the same gram and state dimension."""
    t = np.linspace(0.0, 3.0, 9)
    specs = [
        (("Cosine",), jgp.Cosine()),
        (("Constant", np.float64(0.8)), jgp.Constant(0.8)),
        (("ApproxPeriodic", np.float64(0.6), 4), jgp.ApproxPeriodic(0.6, n_cos=4)),
        (("Sum", (("Matern32",), ("Scaled", ("Stretched", ("Cosine",), 2.0), 0.5))),
         jgp.Matern32() + 0.5 * jgp.Cosine().stretch(2.0)),
    ]
    for spec, jk in specs:
        k = convert.kernel_from_spec(spec)
        _close(tkernels.gram(k, torch.as_tensor(t)), jkernels.gram(jk, jnp.asarray(t)), 1e-14)
        _close(tkernels.gram_diag(k, torch.as_tensor(t)),
               jkernels.gram_diag(jk, jnp.asarray(t)), 1e-14)
        assert tkernels.state_dim(k) == jkernels.state_dim(jk)
    with pytest.raises(ValueError, match="no kernel spec"):
        convert.kernel_from_spec(("Periodic", 1.0))


def test_eq_and_unknown_kernels_raise_type_error_as_reference():
    """EQ has no SDE: sde_atoms, state_dim and to_sde_matrices raise
    TypeError in both packages (sde_atoms with the reference's message); a
    kernel type neither knows raises TypeError from its gram and gram_diag
    too."""
    for jfn, tfn in ((lambda k: jkernels.sde_atoms(k), lambda k: tkernels.sde_atoms(k, device="cpu")),
                     (jkernels.state_dim, tkernels.state_dim),
                     (lambda k: jkernels.to_sde_matrices(k),
                      lambda k: tkernels.to_sde_matrices(k, device="cpu"))):
        with pytest.raises(TypeError):
            jfn(jgp.EQ())
        with pytest.raises(TypeError):
            tfn(tgp.EQ())
    with pytest.raises(TypeError, match="no SDE representation for EQ"):
        tkernels.sde_atoms(tgp.EQ(), device="cpu")

    class JUnknown(jkernels.Kernel):
        pass

    class TUnknown(tkernels.Kernel):
        pass

    t = np.linspace(0.0, 1.0, 3)
    for jfn, tfn in ((jkernels.gram, tkernels.gram), (jkernels.gram_diag, tkernels.gram_diag),
                     (jkernels.state_dim, tkernels.state_dim)):
        args = () if jfn is jkernels.state_dim else (jnp.asarray(t),)
        targs = () if tfn is tkernels.state_dim else (torch.as_tensor(t),)
        with pytest.raises(TypeError):
            jfn(JUnknown(), *args)
        with pytest.raises(TypeError):
            tfn(TUnknown(), *targs)


def test_full_state_det_model_on_block_engine_matches_reference():
    """The D = 3 full-state model Matern12() + 0.5 Cosine().stretch(2) (a
    zero process-noise block) on the port's block engine (K1-K3, K7-K10's
    plain versions on the CPU), one NaN: logpdf, posterior marginals at the
    training inputs and the forward-mode gradient (K4-K6's plain versions)
    against the reference's sequential engine; the full-state lml against
    the port's basis engine."""
    n = 300
    x = JRegularSpacing(0.0, 0.01, n)
    y = np.random.default_rng(5).standard_normal(n)
    y[17] = np.nan
    kern = lambda m, s2=1.0: s2 * m.Matern12() + 0.5 * m.Cosine().stretch(2.0)
    jfx = jgp.to_sde(jgp.GP(kern(jgp)))(x, 0.1)
    tfx = tgp.to_sde(tgp.GP(kern(tgp)), device="cpu")(tt.RegularSpacing(0.0, 0.01, n), 0.1)
    lp_ref = jax.jit(lambda: japi.logpdf(jfx, jnp.asarray(y), engine="sequential"))()
    model = tgp.build_lgssm(tfx)
    lp = tmissings.logpdf_with_missings(model, torch.as_tensor(y), engine="block")
    _close(lp, lp_ref, 1e-9)
    _close(tt.logpdf(tfx, y, engine="basis"), lp, 1e-9)

    m_ref, v_ref = jax.jit(lambda: jpost.marginals(
        jpost.posterior(jfx, jnp.asarray(y))(jfx.x, 0.1), engine="sequential"))()
    m, v = tpost.marginals(tpost.posterior(tfx, y)(tfx.x, 0.1), engine="block")
    _close(m, m_ref, 1e-9, 1e-9 * float(np.abs(m_ref).max()))
    _close(v, v_ref, 1e-9)

    def jloss(p):
        s2, noise = jnp.exp(p)
        fx = jgp.to_sde(jgp.GP(kern(jgp, s2)))(x, noise)
        return japi.logpdf(fx, jnp.asarray(y), engine="sequential")

    v_ref, g_ref = jax.jit(jax.value_and_grad(jloss))(jnp.asarray([0.2, -1.0]))

    def model_fn(p):
        s2, noise = torch.exp(p)
        return tgp.build_lgssm(tgp.to_sde(tgp.GP(kern(tgp, s2)), device="cpu")(
            tt.RegularSpacing(0.0, 0.01, n), noise))

    vg = tt.value_and_grad_fwd_lgssm(model_fn, y)
    value, grad = vg(torch.tensor([0.2, -1.0], dtype=torch.float64))
    _close(value, v_ref, 1e-9)
    _close(grad, g_ref, 1e-8)
