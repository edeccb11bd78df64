"""The port's CUDA kernels on the card, against their plain PyTorch versions
and the CPU path. Every test here carries the `cuda` marker and skips
without a card. The file imports no JAX, so on the H100 it runs without the
reference package and without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

import temporalgps_torch as tt
from temporalgps_torch.gp import GP, ArrayStorage, Matern52, to_sde
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
    assert all(n == 1 for n in tk.launch_counts().values())
    v_cpu, g_cpu = run("cpu", engine="block")
    np.testing.assert_allclose(v_card, v_cpu, rtol=rtol)
    np.testing.assert_allclose(g_card.cpu().numpy(), g_cpu.numpy(), rtol=100 * rtol)
