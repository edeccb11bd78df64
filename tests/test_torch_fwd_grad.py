"""The port's forward-mode gradient path against the reference package, on
the CPU in float64: the three forward-mode phases (plain versions of K4-K6,
temporalgps_torch/ops/kernels.py), `block.logpdf_fwd_grad`, and
`value_and_grad_fwd_lgssm`.

Inputs are made with numpy from a seed and go through both packages. The
reference side is jax.jvp of its plain block schedule
(_phase1_aggregates_lanes, _phase2_prefix, _phase3_lml_lanes) or of its
sequential engine; exactly one case runs its Pallas kernels in interpret
mode. N = 18 in 4 blocks of 5 steps gives 2 padding steps (K4's chunked
schedule also runs at 1 and 37 steps a block); one observation
is NaN; all of the scale, stretch and noise sensitivities are live, so the
noise tangent meets the mask at the missing and the padding steps.

Tolerances: the phases, same algorithm and blocking on both sides, rtol
1e-9 with an absolute floor of 1e-9 of each array's largest entry (entries
that cancel to ~0); gradients end to end rtol 1e-7, atol 1e-10, as the
reference's own test of this path.
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
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock
from temporalgps_tpu.utils.gaussian import Gaussian as JGaussian

import temporalgps_torch as tt
from temporalgps_torch import convert
from temporalgps_torch.gp import GP, Matern12, Matern32, Matern52, build_lgssm, to_sde
from temporalgps_torch.ops import block as tblock
from temporalgps_torch.ops import kernels as tk

torch.set_num_threads(1)

KERNEL_OF_DIM = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
TORCH_KERNEL = {"Matern12": Matern12, "Matern32": Matern32, "Matern52": Matern52}
N, B, NAN_AT, DT = 18, 4, 7, 0.3
P0 = np.array([0.2, -0.4, 0.3])  # log sigma^2, log stretch, log noise
DIRECTIONS = {1: np.array([[0.3, -0.5, 0.8]]), 3: np.eye(3)}


def _close(actual, desired, rtol=1e-9):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        np.asarray(actual), desired, rtol=rtol, atol=rtol * np.abs(desired).max())


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64, order="C"))


def _y(seed, n=N):
    y = np.random.default_rng(seed).standard_normal(n)
    y[min(NAN_AT, n // 2)] = np.nan
    return y


def _jax_model(name, p, n=N):
    s2, sc, noise = jnp.exp(p)
    fx = jgp.to_sde(jgp.GP((s2 * getattr(jgp, name)()).stretch(sc)))(
        JRegularSpacing(0.0, DT, n), noise)
    return japi.build_lgssm(fx)


def _torch_model_fn(name, x=None, n=N):
    def model_fn(p):
        s2, sc, noise = torch.exp(p)
        fx = to_sde(GP((s2 * TORCH_KERNEL[name]()).stretch(sc)), device="cpu")(
            tt.RegularSpacing(0.0, DT, n) if x is None else x, noise)
        return build_lgssm(fx)

    return model_fn


def _leaves(model):
    t, e = model.trans, model.emis
    return (t.As.value, t.offs.value, t.Qs.value, e.H.value, e.h.value, e.s.value,
            t.x0.mean, t.x0.cov)


def _elem_rows(elem):
    """The reference's (A, b, C, eta, J) block arrays -> (K, B) component rows."""
    A, b, C, eta, J = (np.asarray(x) for x in elem)
    n = A.shape[0]
    return np.concatenate([A.reshape(n, -1).T, b.T, C.reshape(n, -1).T, eta.T,
                           J.reshape(n, -1).T])


def _state_rows(mean, cov):
    mean, cov = np.asarray(mean), np.asarray(cov)
    return np.concatenate([mean.T, cov.reshape(cov.shape[0], -1).T])


@functools.lru_cache(maxsize=None)
def _stages_jvp(D, n):
    """(y, v) -> jax.jvp at P0 along v of every stage of the reference's plain
    block schedule on observations y (n,) in B blocks; compiled once for
    every k of a (D, n)."""
    name = KERNEL_OF_DIM[D]

    def stages(p, y):
        model = _jax_model(name, p, n=n)
        model_f, y_f, _ = jmissings.transform_model_and_obs(model, y)
        params_p, y_p, _s_p, n_pad, _ = jblock._pad_tail(model_f, y_f, B)
        blocked = jblock._split_tree((params_p, y_p), B, (n + n_pad) // B)
        agg = jblock._phase1_aggregates_lanes(blocked, B, D, jnp.float64)
        prior = jblock._prior_element(model.trans.x0, D, jnp.float64)
        pref = jblock._phase2_prefix(
            tuple(jnp.concatenate([p_, a_]) for p_, a_ in zip(prior, agg)), None)
        starts = (pref[1][:-1], pref[2][:-1])
        total = jblock._phase3_lml_lanes(blocked, JGaussian(*starts), B, D, jnp.float64)
        return {"leaves": _leaves(model), "agg": agg, "starts": starts, "total": total,
                "streams": (y_f, model_f.emis.s)}

    return jax.jit(lambda y, v: jax.jvp(lambda p: stages(p, y), (jnp.asarray(P0),), (v,)))


@functools.lru_cache(maxsize=None)
def _reference(D, k, n=N):
    """Primal and k tangents of every stage of the reference's plain block
    schedule on n observations in B blocks, and the port's inputs built from
    the same numbers."""
    y = _y(seed=10 * D + k, n=n)
    jvp = functools.partial(_stages_jvp(D, n), jnp.asarray(y))
    primal, tangents = None, []
    for v in DIRECTIONS[k]:
        primal, tangent = jvp(jnp.asarray(v))
        tangents.append(tangent)

    model = convert.lgssm_from_numpy(*primal["leaves"], n, dtype=torch.float64, device="cpu")
    model_tangents = convert.tangent_lgssms_from_numpy(
        [t["leaves"] for t in tangents], n, dtype=torch.float64, device="cpu")
    rows, priors = tblock._tangent_rows(model, model_tangents)
    y_main, s_main, _ = tblock._blocked_streams(
        _t(primal["streams"][0]), _t(primal["streams"][1]), B)
    comps = np.concatenate([_elem_rows(primal["agg"])]
                           + [_elem_rows(t["agg"]) for t in tangents])
    starts = np.concatenate([_state_rows(*primal["starts"])]
                            + [_state_rows(*t["starts"]) for t in tangents])
    totals = np.array([primal["total"]] + [t["total"] for t in tangents])
    return dict(y=y, model=model, model_tangents=model_tangents, rows=rows, priors=priors,
                y_main=y_main, s_main=s_main, comps=comps, starts=starts, totals=totals)


PHASE_CASES = [(D, k) for D in (1, 2, 3) for k in (1, 3)]


@pytest.mark.parametrize("D, k", PHASE_CASES)
def test_phase1_jvp_plain_matches_reference(D, k):
    ref = _reference(D, k)
    comps = tk.phase1_jvp(ref["y_main"], ref["s_main"], ref["rows"], D, k)
    K = tk.elem_rows(D)
    assert comps.shape == ((1 + k) * K, B)
    for j in range(1 + k):
        _close(comps[j * K:(j + 1) * K], ref["comps"][j * K:(j + 1) * K])


@pytest.mark.parametrize("D, k", PHASE_CASES)
def test_phase2_jvp_starts_plain_matches_reference(D, k):
    ref = _reference(D, k)
    starts = tk.phase2_jvp_starts(_t(ref["comps"]), ref["priors"], D, k)
    SD = tk.state_rows(D)
    assert starts.shape == ((1 + k) * SD, B)
    for j in range(1 + k):
        _close(starts[j * SD:(j + 1) * SD], ref["starts"][j * SD:(j + 1) * SD])


@pytest.mark.parametrize("D, k", PHASE_CASES)
def test_phase3_jvp_lml_plain_matches_reference(D, k):
    ref = _reference(D, k)
    lml = tk.phase3_jvp_lml(ref["y_main"], ref["s_main"], ref["rows"], _t(ref["starts"]), D, k)
    assert lml.shape == (1 + k, B)
    _close(lml.sum(dim=1), ref["totals"])


# K4's chunked schedule: L = 1 (fewer steps than chunks), 5 and 37 (neither
# a multiple of the chunk count) steps a block, each with a missing
# observation and a padded tail (n = 4L - 2, or 3 for L = 1).
CHUNK_LENGTHS = {1: 3, 5: N, 37: 146}


@pytest.mark.parametrize("chunks", [4, tk.PHASE1_JVP_CHUNKS])
@pytest.mark.parametrize("L", sorted(CHUNK_LENGTHS))
@pytest.mark.parametrize("D, k", [(D, k) for D in (1, 3) for k in (1, 3)])
def test_phase1_jvp_plain_chunked_matches_serial_and_reference(D, k, L, chunks):
    """The kernel's schedule (each block's steps in `chunks` runs, the run
    aggregates combined in order) gives the serial fold's and the
    reference's aggregates; the noise tangent stays exactly zero over the
    padding steps, which fill some runs and leave others empty."""
    n = CHUNK_LENGTHS[L]
    ref = _reference(D, k, n)
    y_main, s_main, rows = ref["y_main"], ref["s_main"], ref["rows"]
    assert y_main.shape == (L, B)
    chunked = tk.phase1_jvp_plain(y_main, s_main, rows, D, k, chunks=chunks)
    serial = tk.phase1_jvp_plain(y_main, s_main, rows, D, k)
    K = tk.elem_rows(D)
    for j in range(1 + k):
        sets = slice(j * K, (j + 1) * K)
        _close(chunked[sets], serial[sets], rtol=1e-10)
        _close(chunked[sets], ref["comps"][sets], rtol=1e-10)

    noise_only = torch.zeros_like(rows)
    noise_only[0] = rows[0]
    noise_only[1:, -1] = 0.7
    pad = B * L - n
    tail = tk.phase1_jvp_plain(y_main[L - pad:], s_main[L - pad:], noise_only, D, k,
                               chunks=chunks)
    assert torch.equal(tail[K:, B - 1], torch.zeros(k * K, dtype=torch.float64))


def test_noise_tangent_is_masked_at_missing_and_padding_steps():
    """With only the noise tangent live, a step whose streamed s is the
    LARGE_VAR fill must add exactly nothing to the tangent element."""
    D, k = 2, 1
    ref = _reference(2, 1)
    rows = ref["rows"].clone()
    rows[1] = 0.0
    rows[1, -1] = 0.7  # d noise only
    y_main, s_main = ref["y_main"], ref["s_main"]
    assert (s_main >= 1e14).sum().item() == 3  # one NaN, two padding steps
    K = tk.elem_rows(D)
    masked = tk.phase1_jvp_plain(y_main, s_main, rows, D, k)[K:]
    # The same steps, made observed with a huge finite noise below the
    # threshold, get a (tiny) derivative: the mask is what zeroes it.
    s_live = torch.where(s_main >= 1e14, torch.full_like(s_main, 9e13), s_main)
    unmasked = tk.phase1_jvp_plain(y_main, s_live, rows, D, k)[K:]
    block_of_nan = NAN_AT // y_main.shape[0]
    last = tk.phase1_jvp_plain(y_main[-1:], s_main[-1:], rows, D, k)[K:]
    assert torch.equal(last[:, B - 1], torch.zeros(K, dtype=torch.float64))
    assert not torch.equal(masked[:, block_of_nan], unmasked[:, block_of_nan])


@pytest.mark.parametrize("D, k", [(1, 3), (2, 1), (3, 3)])
def test_logpdf_fwd_grad_on_carried_tangent_models(D, k):
    ref = _reference(D, k)
    name = KERNEL_OF_DIM[D]

    def loss(p):
        return jmissings.logpdf_with_missings(
            _jax_model(name, p), jnp.asarray(ref["y"]), engine="sequential")

    jvp = jax.jit(lambda v: jax.jvp(loss, (jnp.asarray(P0),), (v,)))
    want = [jvp(jnp.asarray(v)) for v in DIRECTIONS[k]]
    value, grad = tblock.logpdf_fwd_grad(
        ref["model"], _t(ref["y"]), ref["model_tangents"], n_blocks=B)
    assert grad.shape == (k,)
    np.testing.assert_allclose(value.item(), float(want[0][0]), rtol=1e-10)
    np.testing.assert_allclose(
        grad.numpy(), np.array([float(w[1]) for w in want]), rtol=1e-7, atol=1e-10)


def test_logpdf_fwd_grad_refuses_models_it_does_not_take():
    ref = _reference(2, 1)
    times = torch.linspace(0.0, 4.0, N, dtype=torch.float64) ** 1.5
    irregular = _torch_model_fn("Matern32", x=times)(_t(P0))
    with pytest.raises(TypeError, match="Fill-parameter"):
        tblock.logpdf_fwd_grad(irregular, _t(ref["y"]), ref["model_tangents"])
    with pytest.raises(TypeError, match="Fill-parameter"):
        tblock.logpdf_fwd_grad(ref["model"], _t(ref["y"]), [irregular])
    with pytest.raises(ValueError, match="at least one tangent"):
        tblock.logpdf_fwd_grad(ref["model"], _t(ref["y"]), [])


def _jax_loss(name, y, x=None):
    def loss(p):
        s2, sc, noise = jnp.exp(p)
        fx = jgp.to_sde(jgp.GP((s2 * getattr(jgp, name)()).stretch(sc)))(
            JRegularSpacing(0.0, DT, N) if x is None else x, noise)
        return japi.logpdf(fx, jnp.asarray(y), engine="sequential")

    return loss


@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52"])
def test_value_and_grad_fwd_lgssm_matches_reference(name):
    y = _y(seed=len(name))
    v_ref, g_ref = jax.jit(jlearning.value_and_grad_fwd(_jax_loss(name, y)))(jnp.asarray(P0))
    vg = tt.value_and_grad_fwd_lgssm(_torch_model_fn(name), y, n_blocks=B)
    for _ in range(2):  # the second call reuses the carried y
        value, grad = vg(_t(P0))
        np.testing.assert_allclose(value.item(), float(v_ref), rtol=1e-9)
        np.testing.assert_allclose(grad.numpy(), np.asarray(g_ref), rtol=1e-7, atol=1e-10)


def test_value_and_grad_fwd_lgssm_matches_reference_pallas_interpret():
    """The reference's own fused path (its Pallas kernels in interpret mode),
    at the smallest size that keeps every feature: Matern-1/2, N = 3 in 2
    blocks of 2 steps (one padding step), one NaN, and a live noise tangent,
    which meets the mask at the missing and the padding step. N and the
    steps a block are as small as a padded tail allows; the time goes to
    tracing the kernels' unrolled bodies, which grow with D, hence D = 1
    (D = 2 and 3 are held to the reference's plain schedule above)."""
    n, n_blocks = 3, 2
    y = np.random.default_rng(77).standard_normal(n)
    y[1] = np.nan
    v_ref, g_ref = jlearning.value_and_grad_fwd_lgssm(
        lambda p: _jax_model("Matern12", p, n=n), jnp.asarray(y), n_blocks=n_blocks)(
        jnp.asarray(P0))
    value, grad = tt.value_and_grad_fwd_lgssm(
        _torch_model_fn("Matern12", n=n), y, n_blocks=n_blocks)(_t(P0))
    np.testing.assert_allclose(value.item(), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_ref), rtol=1e-9, atol=1e-10)
    assert abs(float(g_ref[2])) > 1e-3  # the noise sensitivity is live


def test_value_and_grad_fwd_lgssm_falls_back_on_irregular_times():
    times = np.sort(np.random.default_rng(5).uniform(0.0, 4.0, N))
    y = _y(seed=6)
    v_ref, g_ref = jax.jit(jlearning.value_and_grad_fwd(
        _jax_loss("Matern32", y, x=jnp.asarray(times))))(jnp.asarray(P0))
    tk.reset_launch_counts()
    value, grad = tt.value_and_grad_fwd_lgssm(
        _torch_model_fn("Matern32", x=torch.from_numpy(times)), y)(_t(P0))
    np.testing.assert_allclose(value.item(), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_ref), rtol=1e-7, atol=1e-10)
    assert all(n == 0 for n in tk.launch_counts().values())


def test_value_and_grad_fwd_lgssm_custom_fallback_is_used():
    times = torch.linspace(0.0, 4.0, N, dtype=torch.float64) ** 1.5
    vg = tt.value_and_grad_fwd_lgssm(
        _torch_model_fn("Matern12", x=times), _y(seed=8), fallback=lambda p: (p ** 2).sum())
    value, grad = vg(_t(P0))
    np.testing.assert_allclose(value.item(), (P0 ** 2).sum(), rtol=1e-14)
    np.testing.assert_allclose(grad.numpy(), 2 * P0, rtol=1e-14)


@pytest.mark.parametrize(
    "wrapper, error, match",
    [
        ("phase1_wrong_k", ValueError, "packed parameter rows"),
        ("phase1_k_zero", ValueError, "k >= 1"),
        ("phase1_mixed_dtypes", TypeError, "mixed dtypes"),
        ("phase1_stream_shapes", ValueError, "s_blocked"),
        ("phase2_comps_rows", ValueError, "comps must be"),
        ("phase2_priors", ValueError, "priors"),
        ("phase3_starts", ValueError, "starts"),
        ("phase3_D", ValueError, "D in 1..3"),
    ],
)
def test_jvp_wrappers_refuse_what_the_kernels_do_not_take(wrapper, error, match):
    D, k = 2, 3
    ref = _reference(D, k)
    y, s, rows, priors = ref["y_main"], ref["s_main"], ref["rows"], ref["priors"]
    comps, starts = _t(ref["comps"]), _t(ref["starts"])
    calls = {
        "phase1_wrong_k": lambda: tk.phase1_jvp(y, s, rows, D, 2),
        "phase1_k_zero": lambda: tk.phase1_jvp(y, s, rows[:1], D, 0),
        "phase1_mixed_dtypes": lambda: tk.phase1_jvp(y, s.float(), rows, D, k),
        "phase1_stream_shapes": lambda: tk.phase1_jvp(y, s[:-1], rows, D, k),
        "phase2_comps_rows": lambda: tk.phase2_jvp_starts(comps[:-1], priors, D, k),
        "phase2_priors": lambda: tk.phase2_jvp_starts(comps, priors[:-1], D, k),
        "phase3_starts": lambda: tk.phase3_jvp_lml(y, s, rows, starts[:-1], D, k),
        "phase3_D": lambda: tk.phase3_jvp_lml(y, s, rows, starts, 4, k),
    }
    with pytest.raises(error, match=match):
        calls[wrapper]()


def test_jvp_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    D, k = 3, 3
    ref = _reference(D, k)
    tk.reset_launch_counts()
    comps = tk.phase1_jvp(ref["y_main"], ref["s_main"], ref["rows"], D, k)
    assert torch.equal(
        comps, tk.phase1_jvp_plain(ref["y_main"], ref["s_main"], ref["rows"], D, k))
    assert all(n == 0 for n in tk.launch_counts().values())
