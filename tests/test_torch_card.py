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


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_kernels_match_plain_versions_on_card(cuda_device, D, dtype, rtol):
    """Each kernel against its plain version on the same inputs, held on the
    per-block lml downstream of it (the kernels contract to FMA)."""
    rng = np.random.default_rng(D)
    L, B = 37, 300  # B not a multiple of the thread-block sizes
    y = rng.standard_normal((L, B))
    s = np.full((L, B), 0.3)
    s[5, 7] = 1e15
    A = np.eye(D) * 0.9 + 0.01 * rng.standard_normal((D, D))
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda_device)
    packed = tk.pack_params(to(A), to(np.zeros(D)), to(0.1 * np.eye(D)), to(np.ones(D)),
                            to(0.05), dtype)
    y_t, s_t = to(y).contiguous(), to(s).contiguous()
    m0, P0 = to(np.zeros(D)), to(np.eye(D))
    p1 = tk.phase1_aggregate_plain(y_t, s_t, packed, D)
    p2 = tk.phase2_starts_plain(p1, m0, P0, D)
    p3 = tk.phase3_lml_plain(y_t, s_t, packed, p2, D)
    k1 = tk.phase1_aggregate(y_t, s_t, packed, D)
    k2 = tk.phase2_starts(p1, m0, P0, D)
    k3 = tk.phase3_lml(y_t, s_t, packed, p2, D)
    torch.cuda.synchronize()
    via_k1 = tk.phase3_lml_plain(y_t, s_t, packed, tk.phase2_starts_plain(k1, m0, P0, D), D)
    via_k2 = tk.phase3_lml_plain(y_t, s_t, packed, k2, D)
    scale = p3.abs().max().item()
    for got in (via_k1, via_k2, k3):
        assert (got - p3).abs().max().item() <= rtol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_jvp_kernels_match_plain_versions_on_card(cuda_device, D, k, dtype, rtol):
    """K4-K6 against their plain versions (PyTorch's forward-mode autodiff of
    the plain loops) on the same inputs, held on the (1+k, B) lml rows
    downstream, each row scaled by its own largest entry. A missing step and
    a live noise tangent exercise the mask; B = 300 the ragged edge of K5."""
    rng = np.random.default_rng(10 * D + k)
    L, B = 37, 300
    y = rng.standard_normal((L, B))
    s = np.full((L, B), 0.3)
    s[5, 7] = 1e15
    s[L - 1, B - 1] = 1e15
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
    p1 = tk.phase1_jvp_plain(y_t, s_t, rows, D, k)
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
