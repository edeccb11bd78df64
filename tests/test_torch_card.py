"""The port's CUDA kernels on the card, against their plain PyTorch versions
and the CPU path. Every test here carries the `cuda` marker and skips
without a card. The file imports no JAX, so on the H100 it runs without the
reference package and without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import math

import numpy as np
import pytest
import torch

import temporalgps_torch as tt
from temporalgps_torch.gp import GP, ArrayStorage, Matern52, build_lgssm, to_sde
from temporalgps_torch.ops import kernels as tk

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_card.py")
    return torch.device("cuda")


# (L, B) of the chunked kernels' card tests: B = 300 is not a multiple of the
# thread-block sizes; L = 37 is not a multiple of K1's, K4's, K7's or K8's
# chunk count and L = 1 is fewer steps than chunks, so some chunks are
# ragged or empty.
CHUNK_SHAPES = [(37, 300), (37, 96), (1, 96)]


def _streams_with_gaps(rng, L, B):
    """y and s (L, B): a missing step (the LARGE_VAR fill) and, at the end of
    the last block, padding steps."""
    y = rng.standard_normal((L, B))
    s = np.full((L, B), 0.3)
    s[min(5, L - 1), 7] = 1e15
    s[max(L - 2, 0):, B - 1] = 1e15
    return y, s


@pytest.mark.cuda
@pytest.mark.parametrize("L, B", CHUNK_SHAPES)
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_kernels_match_plain_versions_on_card(cuda_device, D, dtype, rtol, L, B):
    """Each kernel against its plain version (K1's in its own chunk order) on
    the same inputs, held on the per-block lml downstream of it (the kernels
    contract to FMA). A missing step, padding steps, and the shapes of
    CHUNK_SHAPES."""
    rng = np.random.default_rng(D)
    y, s = _streams_with_gaps(rng, L, B)
    A = np.eye(D) * 0.9 + 0.01 * rng.standard_normal((D, D))
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda_device)
    packed = tk.pack_params(to(A), to(np.zeros(D)), to(0.1 * np.eye(D)), to(np.ones(D)),
                            to(0.05), dtype)
    y_t, s_t = to(y).contiguous(), to(s).contiguous()
    m0, P0 = to(np.zeros(D)), to(np.eye(D))
    p1 = tk.phase1_aggregate_plain(y_t, s_t, packed, D, chunks=tk.PHASE1_AGGREGATE_CHUNKS)
    p2 = tk.phase2_starts_plain(p1, m0, P0, D)
    p3 = tk.phase3_lml_plain(y_t, s_t, packed, p2, D)
    tk.reset_launch_counts()
    k1 = tk.phase1_aggregate(y_t, s_t, packed, D)
    k2 = tk.phase2_starts(p1, m0, P0, D)
    k3 = tk.phase3_lml(y_t, s_t, packed, p2, D)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["phase1_aggregate"], counts["phase2_starts"], counts["phase3_lml"]) == (1, 1, 1)
    assert k1.shape == p1.shape
    via_k1 = tk.phase3_lml_plain(y_t, s_t, packed, tk.phase2_starts_plain(k1, m0, P0, D), D)
    via_k2 = tk.phase3_lml_plain(y_t, s_t, packed, k2, D)
    scale = p3.abs().max().item()
    for got in (via_k1, via_k2, k3):
        assert bool(torch.isfinite(got).all())
        assert (got - p3).abs().max().item() <= rtol * scale


# The chunked kernels' C entries: the shapes of their pointer arguments and
# the ints before the chunk count, at D = 2 on 5 steps of 4 blocks (k = 1).
_CHUNKED_LAUNCHES = {
    "phase1_aggregate": ([(5, 4), (5, 4), (tk.param_len(2),), (tk.elem_rows(2), 4)],
                         (5, 4, 2), tk.PHASE1_AGGREGATE_CHUNKS),
    "phase1_jvp": ([(5, 4), (5, 4), (2, tk.param_s_len(2)), (2 * tk.elem_rows(2), 4)],
                   (5, 4, 2, 1), tk.PHASE1_JVP_CHUNKS),
    "phase3_states": ([(5, 4), (5, 4), (tk.param_len(2),), (tk.state_rows(2), 4),
                       (tk.state_rows(2), 5, 4)], (5, 4, 2), tk.PHASE3_STATES_CHUNKS),
    "affine_phase1": ([(tk.affine_rows(2), 5, 4), (tk.affine_rows(2), 4)], (5, 4, 2),
                      tk.AFFINE_PHASE1_CHUNKS),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_CHUNKED_LAUNCHES))
def test_chunked_kernels_refuse_another_chunk_count(cuda_device, name):
    """Each chunked kernel refuses at the launch any chunk count but its own,
    which the wrapper passes (so the plain versions' chunks= is the card's
    schedule), and launches with its own."""
    shapes, ints, chunks = _CHUNKED_LAUNCHES[name]
    tensors = [torch.zeros(shape, dtype=torch.float64, device=cuda_device) for shape in shapes]
    for wrong in (chunks // 2, 2 * chunks):
        with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
            tk._launch(name, tensors, (*ints, wrong))
    tk._launch(name, tensors, (*ints, chunks))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("L, B", CHUNK_SHAPES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_jvp_kernels_match_plain_versions_on_card(cuda_device, D, k, dtype, rtol, L, B):
    """K4-K6 against their plain versions (PyTorch's forward-mode autodiff of
    the plain loops; K4's in its own chunk order) on the same inputs, held on
    the (1+k, B) lml rows downstream, each row scaled by its own largest
    entry. A missing step, padding steps and a live noise tangent exercise
    the mask; B = 300 the ragged edge of K5."""
    rng = np.random.default_rng(10 * D + k)
    y, s = _streams_with_gaps(rng, L, B)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda_device)
    sym = lambda X: 0.5 * (X + X.T)
    A = np.eye(D) * 0.9 + 0.01 * rng.standard_normal((D, D))
    primal = tk.pack_params_s(to(A), to(np.zeros(D)), to(0.1 * np.eye(D)), to(np.ones(D)),
                              to(0.05), to(0.0), dtype)
    tangents = [
        tk.pack_params_s(to(0.1 * rng.standard_normal((D, D))), to(0.1 * rng.standard_normal(D)),
                         to(0.05 * sym(rng.standard_normal((D, D)))),
                         to(0.1 * rng.standard_normal(D)), to(0.1 * rng.standard_normal()),
                         to(0.2 * rng.standard_normal()), dtype)
        for _ in range(k)
    ]
    rows = torch.stack([primal, *tangents])
    priors = torch.stack([
        torch.cat([to(np.zeros(D)), to(np.eye(D)).reshape(-1)]),
        *(torch.cat([to(0.1 * rng.standard_normal(D)),
                     to(0.1 * sym(rng.standard_normal((D, D)))).reshape(-1)])
          for _ in range(k)),
    ])
    y_t, s_t = to(y).contiguous(), to(s).contiguous()
    p1 = tk.phase1_jvp_plain(y_t, s_t, rows, D, k, chunks=tk.PHASE1_JVP_CHUNKS)
    p2 = tk.phase2_jvp_starts_plain(p1, priors, D, k)
    p3 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, p2, D, k)
    tk.reset_launch_counts()
    k1 = tk.phase1_jvp(y_t, s_t, rows, D, k)
    k2 = tk.phase2_jvp_starts(p1, priors, D, k)
    k3 = tk.phase3_jvp_lml(y_t, s_t, rows, p2, D, k)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["phase1_jvp"], counts["phase2_jvp_starts"], counts["phase3_jvp_lml"]) == (1, 1, 1)
    assert k1.shape == p1.shape and k2.shape == p2.shape and k3.shape == p3.shape
    via_k1 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, tk.phase2_jvp_starts_plain(k1, priors, D, k), D, k)
    via_k2 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, k2, D, k)
    scale = p3.abs().amax(dim=1, keepdim=True)
    for got in (via_k1, via_k2, k3):
        assert bool(torch.isfinite(got).all())
        assert ((got - p3).abs() / scale).max().item() <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_value_and_grad_fwd_lgssm_on_card_matches_cpu(cuda_device, dtype, rtol):
    N = 5003
    y = np.random.default_rng(1).standard_normal(N)
    y[17] = np.nan

    def run(device):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            fx = to_sde(GP((s2 * Matern52()).stretch(sc)), ArrayStorage(dtype), device=device)(
                tt.RegularSpacing(0.0, 0.01, N), noise)
            return build_lgssm(fx)

        p0 = torch.tensor([0.1, -0.2, -1.0], dtype=torch.float64, device=device)
        value, grad = tt.value_and_grad_fwd_lgssm(model_fn, y)(p0)
        return value.item(), grad.cpu().numpy()

    tk.reset_launch_counts()
    v_card, g_card = run(cuda_device)
    counts = tk.launch_counts()
    assert (counts["phase1_jvp"], counts["phase2_jvp_starts"], counts["phase3_jvp_lml"]) == (1, 1, 1)
    v_cpu, g_cpu = run("cpu")
    np.testing.assert_allclose(v_card, v_cpu, rtol=rtol)
    np.testing.assert_allclose(g_card, g_cpu, rtol=100 * rtol)


@pytest.mark.cuda
def test_value_and_grad_fwd_lgssm_takes_positive_parameters_on_the_default_device(cuda_device):
    """The reference's recipe, every device left at its default: the
    parameters of `positive` and the model both lie on the card."""
    N = 2000
    y = np.random.default_rng(2).standard_normal(N)

    def model_fn(p):
        s2, sc, noise = tt.constrained(p)
        return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)))(
            tt.RegularSpacing(0.0, 0.01, N), noise))

    p0 = tt.positive([1.1, 0.8, 0.4])
    assert p0.device.type == "cuda"
    tk.reset_launch_counts()
    value, grad = tt.value_and_grad_fwd_lgssm(model_fn, y)(p0)
    counts = tk.launch_counts()
    assert (counts["phase1_jvp"], counts["phase2_jvp_starts"], counts["phase3_jvp_lml"]) == (1, 1, 1)
    assert grad.device == p0.device and grad.shape == (3,)
    assert math.isfinite(value.item()) and bool(torch.isfinite(grad).all())


@pytest.mark.cuda
def test_value_and_grad_fwd_lgssm_refuses_on_card_what_the_kernels_do_not_take(
        cuda_device, monkeypatch):
    """Irregular times give per-step parameters, which K4-K6 do not take: on
    the card that is an error, not a run of a plain schedule; an explicit
    `fallback` is the caller's own choice and is used."""
    N = 64
    times = torch.linspace(0.0, 4.0, N, dtype=torch.float64, device=cuda_device) ** 1.5
    y = np.random.default_rng(3).standard_normal(N)

    def model_fn(p):
        s2, sc, noise = torch.exp(p)
        return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)))(times, noise))

    def no_plain_phase(*args, **kwargs):
        raise AssertionError("a plain phase ran on the card")

    for plain in ("phase1_jvp_plain", "phase2_jvp_starts_plain", "phase3_jvp_lml_plain",
                  "phase1_aggregate_plain", "phase2_starts_plain", "phase3_lml_plain"):
        monkeypatch.setattr(tk, plain, no_plain_phase)
    monkeypatch.setattr(tt.learning, "logpdf_with_missings", no_plain_phase)
    p0 = tt.positive([1.1, 0.8, 0.4])
    tk.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4b"):
        tt.value_and_grad_fwd_lgssm(model_fn, y)(p0)
    assert all(n == 0 for n in tk.launch_counts().values())
    value, grad = tt.value_and_grad_fwd_lgssm(
        model_fn, y, fallback=lambda p: (p ** 2).sum())(p0)
    assert torch.allclose(grad, 2 * p0) and torch.allclose(value, (p0 ** 2).sum())


@pytest.mark.cuda
def test_to_sde_default_device_builds_on_the_card(cuda_device):
    fx = to_sde(GP(Matern52()))(tt.RegularSpacing(0.0, 0.1, 16), 0.1)
    assert build_lgssm(fx).device.type == "cuda"


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    y = torch.zeros((5, 4), dtype=torch.float64, device=cuda_device)
    packed = torch.zeros(tk.param_len(2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        tk.phase1_aggregate(y, y[:4], packed, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tk.phase1_aggregate(y.T, y.T, packed, 2)
    with pytest.raises(TypeError, match="mixed dtypes"):
        tk.phase1_aggregate(y, y.float(), packed, 2)
    with pytest.raises(ValueError, match="D in 1..3"):
        tk.phase1_aggregate(y, y, packed, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
def test_fused_logpdf_and_gradient_on_card_match_cpu(cuda_device, dtype, rtol):
    N = 5003
    y = np.random.default_rng(0).standard_normal(N)
    y[17] = np.nan

    def run(device, **engine):
        p = torch.tensor([0.1, -0.2, -1.0], dtype=torch.float64, requires_grad=True)
        s2, sc, noise = torch.exp(p)
        fx = to_sde(GP((s2 * Matern52()).stretch(sc)), ArrayStorage(dtype), device=device)(
            tt.RegularSpacing(0.0, 0.01, N), noise)
        lml = tt.logpdf(fx, y, **engine)
        (grad,) = torch.autograd.grad(lml, p)
        return lml.item(), grad

    tk.reset_launch_counts()
    v_card, g_card = run(cuda_device)
    counts = tk.launch_counts()
    assert (counts["phase1_aggregate"], counts["phase2_starts"], counts["phase3_lml"]) == (1, 1, 1)
    v_cpu, g_cpu = run("cpu", engine="block")
    np.testing.assert_allclose(v_card, v_cpu, rtol=rtol)
    np.testing.assert_allclose(g_card.cpu().numpy(), g_cpu.numpy(), rtol=100 * rtol)


def _rows_rel_err(got, want):
    """Largest error of each row of `got`, relative to the row's largest
    entry in `want` (rows are state or element components)."""
    flat_got, flat_want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = flat_want.abs().amax(dim=1, keepdim=True)
    return ((flat_got - flat_want).abs() / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("L, B", CHUNK_SHAPES)
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_state_kernels_match_plain_versions_on_card(cuda_device, D, dtype, rtol, L, B):
    """K7-K10 against their plain versions (K7's and K8's in their own chunk order) on
    the same inputs, held on the state rows (each scaled by its largest
    entry): K7's own, and for K8 and K9 the states the plain phases compute
    downstream of them. Time-varying affine maps, a missing step, padding
    steps, and the shapes of CHUNK_SHAPES."""
    rng = np.random.default_rng(20 + D)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda_device).contiguous()
    y_np, s_np = _streams_with_gaps(rng, L, B)
    y, s = to(y_np), to(s_np)
    A = np.eye(D) * 0.9 + 0.01 * rng.standard_normal((D, D))
    packed = tk.pack_params(to(A), to(np.zeros(D)), to(0.1 * np.eye(D)), to(np.ones(D)),
                            to(0.05), dtype)
    m0, P0 = to(0.1 * rng.standard_normal(D)), to(np.eye(D))
    starts = tk.phase2_starts_plain(tk.phase1_aggregate_plain(y, s, packed, D), m0, P0, D)
    F = np.eye(D) * 0.95 + 0.02 * rng.standard_normal((L, B, D, D))
    G = 0.1 * rng.standard_normal((L, B, D, D))
    C = np.einsum("lbij,lbkj->lbik", G, G)
    rows = np.concatenate([F.reshape(L, B, D * D), 0.1 * rng.standard_normal((L, B, D)),
                           C.reshape(L, B, D * D)], axis=-1)
    params = to(rows.transpose(2, 0, 1))
    p7 = tk.phase3_states_plain(y, s, packed, starts, D, chunks=tk.PHASE3_STATES_CHUNKS)
    p8 = tk.affine_phase1_plain(params, D, chunks=tk.AFFINE_PHASE1_CHUNKS)
    p9 = tk.affine_phase2_starts_plain(p8, m0, P0, D)
    p10 = tk.affine_phase3_states_plain(params, p9, D)
    tk.reset_launch_counts()
    k7 = tk.phase3_states(y, s, packed, starts, D)
    k8 = tk.affine_phase1(params, D)
    k9 = tk.affine_phase2_starts(p8, m0, P0, D)
    k10 = tk.affine_phase3_states(params, p9, D)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert [counts[n] for n in ("phase3_states", "affine_phase1", "affine_phase2_starts",
                                "affine_phase3_states")] == [1, 1, 1, 1]
    via_k8 = tk.affine_phase3_states_plain(params, tk.affine_phase2_starts_plain(k8, m0, P0, D), D)
    via_k9 = tk.affine_phase3_states_plain(params, k9, D)
    for got, want in ((k7, p7), (via_k8, p10), (via_k9, p10), (k10, p10)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rows_rel_err(got, want) <= rtol


def _posterior_marginals(device, x_pr=None, N=3001, seed=4):
    """gp.posterior marginals of a Matern-5/2 float64 model with one missing
    value, at the training inputs or at x_pr."""
    from temporalgps_torch.gp import posterior as gpost

    y = np.random.default_rng(seed).standard_normal(N)
    y[11] = np.nan
    x = tt.RegularSpacing(0.0, 0.01, N)
    fx = to_sde(GP((1.3 * Matern52()).stretch(0.7)), ArrayStorage(torch.float64),
                device=device)(x, 0.2)
    m, v = gpost.marginals(gpost.posterior(fx, y)(x if x_pr is None else x_pr, 0.1))
    return m.cpu().numpy(), v.cpu().numpy()


_STATE_KERNELS = ("phase1_aggregate", "phase2_starts", "phase3_states", "affine_phase1",
                  "affine_phase2_starts", "affine_phase3_states")


@pytest.mark.cuda
def test_posterior_marginals_on_card_match_cpu(cuda_device):
    """The posterior path on the card runs K1, K2, K7 and K8-K10 (not K3) and
    agrees with the same call on the CPU (the plain versions)."""
    tk.reset_launch_counts()
    m_card, v_card = _posterior_marginals(cuda_device)
    counts = tk.launch_counts()
    assert all(counts[name] == 1 for name in _STATE_KERNELS) and counts["phase3_lml"] == 0
    m_cpu, v_cpu = _posterior_marginals("cpu")
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-9, atol=1e-9 * np.abs(m_cpu).max())
    np.testing.assert_allclose(v_card, v_cpu, rtol=1e-9)


@pytest.mark.cuda
def test_posterior_marginals_at_new_times_on_card(cuda_device):
    """At new times the merged model has per-step transitions: the posterior
    runs on the sequential engine (no K1, K2, K7) and its marginals on
    K8-K10; the result agrees with the CPU."""
    x_pr = np.sort(np.random.default_rng(5).uniform(-0.5, 21.0, 300))
    tk.reset_launch_counts()
    m_card, v_card = _posterior_marginals(cuda_device, x_pr=x_pr, N=2000)
    counts = tk.launch_counts()
    assert [counts[n] for n in _STATE_KERNELS] == [0, 0, 0, 1, 1, 1]
    m_cpu, v_cpu = _posterior_marginals("cpu", x_pr=x_pr, N=2000)
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-9, atol=1e-9 * np.abs(m_cpu).max())
    np.testing.assert_allclose(v_card, v_cpu, rtol=1e-9)


@pytest.mark.cuda
def test_posterior_covariance_is_refused_on_card(cuda_device):
    from temporalgps_torch.gp import posterior as gpost

    fx = to_sde(GP(Matern52()))(tt.RegularSpacing(0.0, 0.1, 16), 0.1)
    with pytest.raises(NotImplementedError, match="Intentionally not implemented"):
        gpost.cov(gpost.posterior(fx, np.zeros(16))(fx.x))
