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
from temporalgps_torch.gp import posterior as tpost
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.models import missings as tmissings
from temporalgps_torch.ops import kernels as tk

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_card.py")
    return torch.device("cuda")


# (L, B) of the chunked kernels' card tests: B = 300 is not a multiple of the
# thread-block sizes; L = 37 is not a multiple of K1's, K3's, K4's, K6's,
# K7's, K8's or K10's chunk count and L = 1 is fewer steps than chunks, so
# some chunks are ragged or empty.
CHUNK_SHAPES = [(37, 300), (37, 96), (1, 96)]


def _streams_with_gaps(rng, L, B):
    """y and s (L, B): a missing step (the LARGE_VAR fill) and, at the end of
    the last block, padding steps."""
    y = rng.standard_normal((L, B))
    s = np.full((L, B), 0.3)
    s[min(5, L - 1), min(7, B - 1)] = 1e15
    s[max(L - 2, 0):, B - 1] = 1e15
    return y, s


def _value_inputs(rng, D, dtype, device, L, B):
    """Streams with gaps, packed parameters and a prior for K1-K3."""
    y, s = _streams_with_gaps(rng, L, B)
    A = np.eye(D) * 0.9 + 0.01 * rng.standard_normal((D, D))
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    packed = tk.pack_params(to(A), to(np.zeros(D)), to(0.1 * np.eye(D)), to(np.ones(D)),
                            to(0.05), dtype)
    return to(y).contiguous(), to(s).contiguous(), packed, to(np.zeros(D)), to(np.eye(D))


@pytest.mark.cuda
@pytest.mark.parametrize("L, B", CHUNK_SHAPES)
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_kernels_match_plain_versions_on_card(cuda_device, D, dtype, rtol, L, B):
    """Each kernel against its plain version (K1's and K3's in their own
    chunk order) on the same inputs, held on the per-block lml downstream of
    it (the kernels contract to FMA): K1's block and run aggregates, K2's
    starts, and K3 fed K1's run aggregates. A missing step, padding steps,
    and the shapes of CHUNK_SHAPES."""
    y_t, s_t, packed, m0, P0 = _value_inputs(np.random.default_rng(D), D, dtype, cuda_device,
                                             L, B)
    p1, p_runs = tk.phase1_aggregate_plain(y_t, s_t, packed, D,
                                           chunks=tk.PHASE1_AGGREGATE_CHUNKS)
    p2 = tk.phase2_starts_plain(p1, m0, P0, D)
    p3 = tk.phase3_lml_plain(y_t, s_t, packed, p2, D, p_runs)
    tk.reset_launch_counts()
    k1, k_runs = tk.phase1_aggregate(y_t, s_t, packed, D)
    k2 = tk.phase2_starts(p1, m0, P0, D)
    k3 = tk.phase3_lml(y_t, s_t, packed, p2, D, k_runs)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["phase1_aggregate"], counts["phase2_starts"], counts["phase3_lml"]) == (1, 1, 1)
    assert k1.shape == p1.shape and k_runs.shape == p_runs.shape
    via_k1 = tk.phase3_lml_plain(y_t, s_t, packed, tk.phase2_starts_plain(k1, m0, P0, D), D,
                                 p_runs)
    via_k_runs = tk.phase3_lml_plain(y_t, s_t, packed, p2, D, k_runs)
    via_k2 = tk.phase3_lml_plain(y_t, s_t, packed, k2, D, p_runs)
    for got, want in ((via_k1, p3), (via_k_runs, p3), (via_k2, p3), (k3, via_k_runs)):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= rtol * want.abs().max().item()


def _trans_rows(rng, D, dtype, device, L, B):
    """Per-step transitions (KT, L, B) of K1's, K3's and K7's streamed forms:
    stable A, small a, PSD Q, and identity rows on the padding steps at the
    end of the last block (as _streams_with_gaps marks them)."""
    F = np.eye(D) * 0.9 + 0.02 * rng.standard_normal((L, B, D, D))
    G = 0.3 * rng.standard_normal((L, B, D, D))
    rows = np.concatenate([F.reshape(L, B, D * D), 0.05 * rng.standard_normal((L, B, D)),
                           np.einsum("lbij,lbkj->lbik", G, G).reshape(L, B, D * D)], axis=-1)
    rows[max(L - 2, 0):, B - 1] = np.concatenate([np.eye(D).ravel(), np.zeros(D + D * D)])
    return torch.as_tensor(rows.transpose(2, 0, 1), dtype=dtype, device=device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("L, B", CHUNK_SHAPES)
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_streamed_kernels_match_plain_versions_on_card(cuda_device, D, dtype, rtol, L, B):
    """The streamed forms of K1, K3 and K7 (per-step (A, a, Q) rows)
    against their plain versions in their chunk order on the same inputs:
    K1's block and run aggregates held on the per-block lml downstream, K3
    fed K1's run aggregates, K7's states row by row. A missing step,
    padding steps with identity rows, and the shapes of CHUNK_SHAPES."""
    rng = np.random.default_rng(10 + D)
    y_t, s_t, packed, m0, P0 = _value_inputs(rng, D, dtype, cuda_device, L, B)
    rows = _trans_rows(rng, D, dtype, cuda_device, L, B)
    p1, p_runs = tk.phase1_aggregate_plain(y_t, s_t, packed, D, chunks=tk.PHASE1_AGGREGATE_CHUNKS,
                                           trans_rows=rows)
    p2 = tk.phase2_starts_plain(p1, m0, P0, D)
    p3 = tk.phase3_lml_plain(y_t, s_t, packed, p2, D, p_runs, trans_rows=rows)
    p7 = tk.phase3_states_plain(y_t, s_t, packed, p2, D, chunks=tk.PHASE3_STATES_CHUNKS,
                                trans_rows=rows)
    tk.reset_launch_counts()
    k1, k_runs = tk.phase1_aggregate_streamed(y_t, s_t, packed, D, rows)
    k3 = tk.phase3_lml_streamed(y_t, s_t, packed, p2, D, k_runs, rows)
    k7 = tk.phase3_states_streamed(y_t, s_t, packed, p2, D, rows)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["phase1_aggregate_streamed"], counts["phase3_lml_streamed"],
            counts["phase3_states_streamed"]) == (1, 1, 1)
    assert counts["phase1_aggregate"] == counts["phase3_lml"] == counts["phase3_states"] == 0
    via_k1 = tk.phase3_lml_plain(y_t, s_t, packed, tk.phase2_starts_plain(k1, m0, P0, D), D,
                                 p_runs, trans_rows=rows)
    via_k_runs = tk.phase3_lml_plain(y_t, s_t, packed, p2, D, k_runs, trans_rows=rows)
    for got, want in ((via_k1, p3), (via_k_runs, p3), (k3, via_k_runs)):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= rtol * want.abs().max().item()
    assert k7.shape == p7.shape and bool(torch.isfinite(k7).all())
    scale = p7.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    assert ((k7 - p7).abs() / scale).max().item() <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
def test_irregular_times_run_the_streamed_kernels_on_card(cuda_device, monkeypatch, dtype, rtol):
    """An irregular-times model on the card: logpdf runs streamed K1, K2,
    streamed K3; filter_ and the posterior streamed K1, K2, streamed K7, and
    the posterior marginals K8-K10 after them; no sequential step runs.
    Each matches the float64 CPU port (the lane path and the plain
    versions): 1e-10 in float64, 1e-3 in float32 (relative to the largest
    entry)."""
    N = 5000
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.uniform(0.5e-3, 1.5e-3, N))
    y = rng.standard_normal(N)
    y[123] = np.nan

    def no_sequential(*args, **kwargs):
        raise AssertionError("the sequential engine ran on the card")

    def run(dt, device):
        fx = to_sde(GP((1.3 * Matern52()).stretch(0.7)), ArrayStorage(dt), device=device)(
            torch.as_tensor(times, device=device), 0.1)
        model = build_lgssm(fx)
        model_f, y_f, _ = tmissings.transform_model_and_obs(
            model, torch.as_tensor(y, dtype=dt, device=device))
        engine = dict(engine="block") if device == "cpu" else {}
        tk.reset_launch_counts()
        lml = tt.logpdf(fx, y, **engine)
        lml_counts = tk.launch_counts()
        tk.reset_launch_counts()
        xf = tlgssm.filter_(model_f, y_f, **engine)
        filter_counts = tk.launch_counts()
        tk.reset_launch_counts()
        m, v = tpost.marginals(tpost.posterior(fx, y)(fx.x, 0.1), **engine)
        post_counts = tk.launch_counts()
        return (lml, xf.mean, xf.cov, m, v), (lml_counts, filter_counts, post_counts)

    want, _ = run(torch.float64, "cpu")
    monkeypatch.setattr(tlgssm, "_logpdf_sequential", no_sequential)
    monkeypatch.setattr(tlgssm, "_iteration", no_sequential)
    got, (lml_counts, filter_counts, post_counts) = run(dtype, "cuda")
    torch.cuda.synchronize()
    streamed = ("phase1_aggregate_streamed", "phase2_starts")
    assert all(lml_counts[n] == 1 for n in streamed + ("phase3_lml_streamed",))
    assert all(filter_counts[n] == 1 for n in streamed + ("phase3_states_streamed",))
    assert all(post_counts[n] == 1 for n in streamed + (
        "phase3_states_streamed", "affine_phase1", "affine_phase2_starts",
        "affine_phase3_states"))
    for counts in (lml_counts, filter_counts, post_counts):
        assert counts["phase1_aggregate"] == counts["phase3_lml"] == counts["phase3_states"] == 0
    for g, w in zip(got, want):
        g = g.double().cpu()
        assert bool(torch.isfinite(g).all())
        assert (g - w).abs().max().item() <= rtol * w.abs().max().item()


def _jvp_inputs(rng, D, k, dtype, device, L, B):
    """Streams with gaps, (1+k, PK2) parameter rows with a live noise
    tangent, and (1+k, SD) priors for K4-K6."""
    y, s = _streams_with_gaps(rng, L, B)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
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
    return to(y).contiguous(), to(s).contiguous(), rows, priors


def _affine_maps(rng, D, dtype, device, L, B):
    """Time-varying stable affine maps (KT, L, B)."""
    F = np.eye(D) * 0.95 + 0.02 * rng.standard_normal((L, B, D, D))
    G = 0.1 * rng.standard_normal((L, B, D, D))
    C = np.einsum("lbij,lbkj->lbik", G, G)
    rows = np.concatenate([F.reshape(L, B, D * D), 0.1 * rng.standard_normal((L, B, D)),
                           C.reshape(L, B, D * D)], axis=-1)
    return torch.as_tensor(rows.transpose(2, 0, 1), dtype=dtype, device=device).contiguous()


def _scan_case(scan, rng, D, dtype, device, B):
    """(kernel starts, plain starts, the rows downstream of both, wrapper) of
    one scan on aggregates that the plain phase 1 makes from (37, B) inputs:
    the per-block lml (K2), the (1+k, B) lml rows (K5, k tangents), the
    states after every step (K9)."""
    if scan == "phase2_starts":
        y_t, s_t, packed, m0, P0 = _value_inputs(rng, D, dtype, device, 37, B)
        p1, p_runs = tk.phase1_aggregate_plain(y_t, s_t, packed, D,
                                               chunks=tk.PHASE1_AGGREGATE_CHUNKS)
        starts = (tk.phase2_starts(p1, m0, P0, D), tk.phase2_starts_plain(p1, m0, P0, D))
        downstream = lambda st: tk.phase3_lml_plain(y_t, s_t, packed, st, D, p_runs)[None]
        return (*starts, downstream, tk.phase2_starts)
    if scan.startswith("phase2_jvp_starts"):
        k = int(scan[-1])
        y_t, s_t, rows, priors = _jvp_inputs(rng, D, k, dtype, device, 37, B)
        p1, p_runs = tk.phase1_jvp_plain(y_t, s_t, rows, D, k, chunks=tk.PHASE1_JVP_CHUNKS)
        starts = (tk.phase2_jvp_starts(p1, priors, D, k), tk.phase2_jvp_starts_plain(p1, priors, D, k))
        downstream = lambda st: tk.phase3_jvp_lml_plain(y_t, s_t, rows, st, D, k, p_runs)
        return (*starts, downstream, tk.phase2_jvp_starts)
    params = _affine_maps(rng, D, dtype, device, 37, B)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    m0, P0 = to(0.1 * rng.standard_normal(D)), to(np.eye(D))
    p8, p_runs = tk.affine_phase1_plain(params, D, chunks=tk.AFFINE_PHASE1_CHUNKS)
    starts = (tk.affine_phase2_starts(p8, m0, P0, D), tk.affine_phase2_starts_plain(p8, m0, P0, D))
    downstream = lambda st: tk.affine_phase3_states_plain(params, st, D, p_runs)
    return (*starts, downstream, tk.affine_phase2_starts)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 96, 2048, 5000])
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("scan", ["phase2_starts", "phase2_jvp_starts_k1", "phase2_jvp_starts_k3",
                                  "affine_phase2_starts"])
def test_phase2_kernel_takes_any_block_count(cuda_device, scan, D, dtype, rtol, B):
    """The three scans of the cluster scan (csrc/scan.cuh), each on the
    aggregates that its plain phase 1 makes from (37, B) inputs, held on the
    rows the plain phases compute downstream, each row scaled by its largest
    entry: K2 on the per-block lml, K5 (k = 1 and 3) on the (1+k, B) lml
    rows, K9 on time-varying affine maps' states. One block, a width that is
    not a multiple of a warp, one lane a block in one round (2048), and
    several rounds (5000)."""
    rng = np.random.default_rng(B + D)
    tk.reset_launch_counts()
    got, want, downstream, wrapper = _scan_case(scan, rng, D, dtype, cuda_device, B)
    torch.cuda.synchronize()
    assert wrapper.launches == 1 and got.shape == want.shape
    rows_got, rows_want = downstream(got), downstream(want)
    assert bool(torch.isfinite(rows_got).all())
    assert _rows_rel_err(rows_got, rows_want) <= rtol


# The chunked kernels' C entries: the shapes of their pointer arguments and
# the ints before the chunk count, at D = 2 on 5 steps of 4 blocks (k = 1).
_VALUE_RUNS = (tk.PHASE1_AGGREGATE_CHUNKS, tk.elem_rows(2), 4)
_JVP_RUNS = (tk.PHASE1_JVP_CHUNKS, 2 * tk.elem_rows(2), 4)
_AFFINE_RUNS = (tk.AFFINE_PHASE1_CHUNKS, tk.affine_rows(2), 4)
# K1, K3 and K7 take the transition rows of their streamed forms after the
# packed parameters (the chunk count is checked before the form is chosen).
_TRANS_ROWS = (tk.affine_rows(2), 5, 4)
_CHUNKED_LAUNCHES = {
    "phase1_aggregate": ([(5, 4), (5, 4), (tk.param_len(2),), _TRANS_ROWS, (tk.elem_rows(2), 4),
                          _VALUE_RUNS], (5, 4, 2), tk.PHASE1_AGGREGATE_CHUNKS),
    "phase3_lml": ([(5, 4), (5, 4), (tk.param_len(2),), _TRANS_ROWS, (tk.state_rows(2), 4),
                    _VALUE_RUNS, (4,)], (5, 4, 2), tk.PHASE1_AGGREGATE_CHUNKS),
    "phase1_jvp": ([(5, 4), (5, 4), (2, tk.param_s_len(2)), (2 * tk.elem_rows(2), 4), _JVP_RUNS],
                   (5, 4, 2, 1), tk.PHASE1_JVP_CHUNKS),
    "phase3_jvp_lml": ([(5, 4), (5, 4), (2, tk.param_s_len(2)), (2 * tk.state_rows(2), 4),
                        _JVP_RUNS, (2, 4)], (5, 4, 2, 1), tk.PHASE1_JVP_CHUNKS),
    "phase3_states": ([(5, 4), (5, 4), (tk.param_len(2),), _TRANS_ROWS, (tk.state_rows(2), 4),
                       (tk.state_rows(2), 5, 4)], (5, 4, 2), tk.PHASE3_STATES_CHUNKS),
    "affine_phase1": ([(tk.affine_rows(2), 5, 4), (tk.affine_rows(2), 4), _AFFINE_RUNS],
                      (5, 4, 2), tk.AFFINE_PHASE1_CHUNKS),
    "affine_phase3_states": ([(tk.affine_rows(2), 5, 4), (tk.state_rows(2), 4), _AFFINE_RUNS,
                              (tk.state_rows(2), 5, 4)], (5, 4, 2), tk.AFFINE_PHASE1_CHUNKS),
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
    the plain loops; K4's and K6's in their own chunk order) on the same
    inputs, held on the (1+k, B) lml rows downstream, each row scaled by its
    own largest entry: K4's block and run aggregates, K5's starts, and K6 fed
    K4's run aggregates. A missing step, padding steps and a live noise
    tangent exercise the mask; B = 300 the ragged edge of K5."""
    y_t, s_t, rows, priors = _jvp_inputs(np.random.default_rng(10 * D + k), D, k, dtype,
                                         cuda_device, L, B)
    p1, p_runs = tk.phase1_jvp_plain(y_t, s_t, rows, D, k, chunks=tk.PHASE1_JVP_CHUNKS)
    p2 = tk.phase2_jvp_starts_plain(p1, priors, D, k)
    p3 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, p2, D, k, p_runs)
    tk.reset_launch_counts()
    k1, k_runs = tk.phase1_jvp(y_t, s_t, rows, D, k)
    k2 = tk.phase2_jvp_starts(p1, priors, D, k)
    k3 = tk.phase3_jvp_lml(y_t, s_t, rows, p2, D, k, k_runs)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["phase1_jvp"], counts["phase2_jvp_starts"], counts["phase3_jvp_lml"]) == (1, 1, 1)
    assert k1.shape == p1.shape and k_runs.shape == p_runs.shape
    assert k2.shape == p2.shape and k3.shape == p3.shape
    via_k1 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, tk.phase2_jvp_starts_plain(k1, priors, D, k),
                                     D, k, p_runs)
    via_k_runs = tk.phase3_jvp_lml_plain(y_t, s_t, rows, p2, D, k, k_runs)
    via_k2 = tk.phase3_jvp_lml_plain(y_t, s_t, rows, k2, D, k, p_runs)
    for got, want in ((via_k1, p3), (via_k_runs, p3), (via_k2, p3), (k3, via_k_runs)):
        assert bool(torch.isfinite(got).all())
        assert ((got - want).abs() / want.abs().amax(dim=1, keepdim=True)).max().item() <= rtol


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
    the card the gradient takes the general block schedule's forward mode
    (the lane path), with no sequential step, and matches the CPU port; an
    explicit `fallback` is the caller's own choice and is used."""
    N = 64
    times = torch.linspace(0.0, 4.0, N, dtype=torch.float64) ** 1.5
    y = np.random.default_rng(3).standard_normal(N)

    def model_fn_on(device):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)), device=device)(
                times.to(device), noise))

        return model_fn

    def no_sequential(*args, **kwargs):
        raise AssertionError("the sequential engine ran on the card")

    monkeypatch.setattr(tlgssm, "_logpdf_sequential", no_sequential)
    p0 = tt.positive([1.1, 0.8, 0.4])
    tk.reset_launch_counts()
    value, grad = tt.value_and_grad_fwd_lgssm(model_fn_on(cuda_device), y)(p0)
    assert tk.launch_counts()["phase1_jvp"] == 0
    assert grad.device == p0.device and grad.shape == (3,)
    v_cpu, g_cpu = tt.value_and_grad_fwd_lgssm(model_fn_on("cpu"), y)(p0.cpu())
    assert abs(value.item() - v_cpu.item()) <= 1e-10 * abs(v_cpu.item())
    assert (grad.cpu() - g_cpu).abs().max().item() <= 1e-8 * g_cpu.abs().max().item()
    value, grad = tt.value_and_grad_fwd_lgssm(
        model_fn_on(cuda_device), y, fallback=lambda p: (p ** 2).sum())(p0)
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
    """K7-K10 against their plain versions (K7's, K8's and K10's in their own
    chunk order) on the same inputs, held on the state rows (each scaled by
    its largest entry): K7's own, K10's fed K8's run aggregates, and for
    K8's block and run aggregates and K9 the states the plain phases compute
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
    starts = tk.phase2_starts_plain(tk.phase1_aggregate_plain(y, s, packed, D)[0], m0, P0, D)
    params = _affine_maps(rng, D, dtype, cuda_device, L, B)
    p7 = tk.phase3_states_plain(y, s, packed, starts, D, chunks=tk.PHASE3_STATES_CHUNKS)
    p8, p_runs = tk.affine_phase1_plain(params, D, chunks=tk.AFFINE_PHASE1_CHUNKS)
    p9 = tk.affine_phase2_starts_plain(p8, m0, P0, D)
    p10 = tk.affine_phase3_states_plain(params, p9, D, p_runs)
    tk.reset_launch_counts()
    k7 = tk.phase3_states(y, s, packed, starts, D)
    k8, k_runs = tk.affine_phase1(params, D)
    k9 = tk.affine_phase2_starts(p8, m0, P0, D)
    k10 = tk.affine_phase3_states(params, p9, D, k_runs)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert [counts[n] for n in ("phase3_states", "affine_phase1", "affine_phase2_starts",
                                "affine_phase3_states")] == [1, 1, 1, 1]
    assert k_runs.shape == p_runs.shape
    via_k8 = tk.affine_phase3_states_plain(params, tk.affine_phase2_starts_plain(k8, m0, P0, D),
                                           D, p_runs)
    via_k_runs = tk.affine_phase3_states_plain(params, p9, D, k_runs)
    via_k9 = tk.affine_phase3_states_plain(params, k9, D, p_runs)
    for got, want in ((k7, p7), (via_k8, p10), (via_k_runs, p10), (via_k9, p10),
                      (k10, via_k_runs)):
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
    runs on the streamed K1, K2 and the streamed K7 (not the constant K1 and
    K7) and its marginals on K8-K10; the result agrees with the CPU."""
    x_pr = np.sort(np.random.default_rng(5).uniform(-0.5, 21.0, 300))
    tk.reset_launch_counts()
    m_card, v_card = _posterior_marginals(cuda_device, x_pr=x_pr, N=2000)
    counts = tk.launch_counts()
    assert [counts[n] for n in _STATE_KERNELS] == [0, 1, 0, 1, 1, 1]
    assert counts["phase1_aggregate_streamed"] == counts["phase3_states_streamed"] == 1
    m_cpu, v_cpu = _posterior_marginals("cpu", x_pr=x_pr, N=2000)
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-9, atol=1e-9 * np.abs(m_cpu).max())
    np.testing.assert_allclose(v_card, v_cpu, rtol=1e-9)


@pytest.mark.cuda
def test_posterior_covariance_is_refused_on_card(cuda_device):
    from temporalgps_torch.gp import posterior as gpost

    fx = to_sde(GP(Matern52()))(tt.RegularSpacing(0.0, 0.1, 16), 0.1)
    with pytest.raises(NotImplementedError, match="Intentionally not implemented"):
        gpost.cov(gpost.posterior(fx, np.zeros(16))(fx.x))


# ---------------------------------------------------------------------------
# Composite models, sampling, the posterior's logpdf
# ---------------------------------------------------------------------------

def _composite_gp(name, s=None):
    """sum3: a Sum of a scaled, stretched Matern-1/2 and a stretched
    Matern-3/2 (D = 3); prod2: a Product of Matern-1/2 and Matern-3/2
    (D = 2); sum3_mean: sum3 with a mean function of the times. `s` are the
    hyperparameters as tensors (scales and stretches), for a gradient."""
    from temporalgps_torch.gp import CustomMean, Matern12, Matern32

    if name == "prod2":
        sc1, st1, st2 = (0.8, 2.0, 0.5) if s is None else s
        return GP((sc1 * Matern12()).stretch(st1) * Matern32().stretch(st2))
    s1, st1, s2, st2 = (0.5, 2.0, 1.0, 0.5) if s is None else s
    k = (s1 * Matern12()).stretch(st1) + (s2 * Matern32()).stretch(st2)
    return GP(k, CustomMean(lambda t: 0.3 * torch.sin(t))) if name == "sum3_mean" else GP(k)


def _composite_calls(name, device, N=3001):
    """(lml, value, gradient, posterior means, posterior variances) of the
    composite model, float64, on `device` (the block engine: the kernels on
    the card, their plain versions on the CPU); and the launch counts of each
    of the three calls."""
    y = np.random.default_rng(6).standard_normal(N)
    y[13] = np.nan
    x = tt.RegularSpacing(0.0, 0.01, N)
    fx = to_sde(_composite_gp(name), ArrayStorage(torch.float64), device=device)(x, 0.2)
    counts = []
    tk.reset_launch_counts()
    lml = tt.logpdf(fx, y, engine="block").item()
    counts.append(tk.launch_counts())

    def model_fn(p):
        p = torch.exp(p)
        return build_lgssm(to_sde(_composite_gp(name, p[:-1]), device=device)(x, p[-1]))

    k = 4 if name == "prod2" else 5
    p0 = torch.full((k,), -0.1, dtype=torch.float64, device=device)
    tk.reset_launch_counts()
    value, grad = tt.value_and_grad_fwd_lgssm(model_fn, y)(p0)
    counts.append(tk.launch_counts())
    tk.reset_launch_counts()
    m, v = tpost.marginals(tpost.posterior(fx, y)(x, 0.1), engine="block")
    counts.append(tk.launch_counts())
    out = (np.array([lml]), np.array([value.item()]), grad.cpu().numpy(), m.cpu().numpy(),
           v.cpu().numpy())
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sum3", "prod2", "sum3_mean"])
def test_composite_models_on_card_launch_the_kernels_and_match_cpu(cuda_device, name):
    """A Sum, a Product and a Sum with a mean function (its per-step h moved
    into y) on RegularSpacing: logpdf launches K1-K3, the forward-mode
    gradient (k = 5 or 4 hyperparameters) K4-K6, and the posterior marginals
    K1, K2, K7 and K8-K10; each agrees with the CPU port, float64: 1e-10,
    the gradient 1e-8."""
    got, counts = _composite_calls(name, cuda_device)
    value_kernels = ("phase1_aggregate", "phase2_starts", "phase3_lml")
    assert [counts[0][n] for n in value_kernels] == [1, 1, 1]
    jvp_kernels = ("phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml")
    if name == "sum3_mean":  # a per-step h: the general schedule's forward mode
        assert all(counts[1][n] == 0 for n in jvp_kernels)
    else:
        assert [counts[1][n] for n in jvp_kernels] == [1, 1, 1]
    assert all(counts[2][n] == 1 for n in _STATE_KERNELS) and counts[2]["phase3_lml"] == 0
    want, _ = _composite_calls(name, "cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = 1e-8 if i == 2 else 1e-10
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


def _eps(N, D, seed=8):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((N, D))), torch.as_tensor(rng.standard_normal(N)),
            torch.as_tensor(rng.standard_normal(D)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rand_on_card_launches_the_affine_kernels_once_and_matches_cpu(cuda_device, dtype):
    """The prior rand of a Sum with a mean function: K8, K9 and K10 once
    each, a seeded card generator gives the same draws twice, `n` stacks
    draws; rand_with_eps on the same normals agrees with the CPU port
    (float64 1e-10, float32 1e-4 of the largest value)."""
    N = 4001
    x = tt.RegularSpacing(0.0, 0.01, N)
    make = lambda device: to_sde(_composite_gp("sum3_mean"), ArrayStorage(dtype),
                                 device=device)(x, 0.1)
    fx = make(cuda_device)
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(3)
    tk.reset_launch_counts()
    draw = tt.rand(gen(), fx)
    counts = tk.launch_counts()
    assert [counts[n] for n in _STATE_KERNELS[3:]] == [1, 1, 1]
    assert sum(counts.values()) == 3
    assert draw.shape == (N,) and draw.dtype == dtype and bool(torch.isfinite(draw).all())
    assert torch.equal(draw, tt.rand(gen(), fx))
    assert tt.rand(gen(), fx, n=3).shape == (3, N)
    eps = _eps(N, 3)
    got, want = (tlgssm.rand_with_eps(build_lgssm(make(dev)), *(e.to(dev, dtype) for e in eps),
                                      engine="block")
                 for dev in (cuda_device, "cpu"))
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("at", ["training", "new"])
def test_posterior_logpdf_and_rand_on_card_match_cpu(cuda_device, at):
    """The posterior of a Sum, float64, at the training inputs (merged with
    themselves) and at new times: its logpdf runs the reverse model's
    filter on the streamed K1, K2 and the streamed K3 (not the constant K1,
    K3), its rand the streamed K1, K2, the streamed K7, then K8-K10. The
    logpdf agrees with the CPU port within 1e-10; the sample on the same
    normals within 1e-8 of its largest value: at short steps the reverse
    model's Q is a difference of nearly equal covariances, which one
    rounding of the filtering states moves by ~1e-6 of itself, and the
    sample takes its square root."""
    N = 2000
    y = np.random.default_rng(9).standard_normal(N)
    y[[0, 17, N - 1]] = np.nan
    x = tt.RegularSpacing(0.0, 0.01, N)
    x_pr = (x.to_array().numpy() if at == "training"
            else np.sort(np.random.default_rng(10).uniform(-0.5, 21.0, 300)))
    y_pr = np.random.default_rng(11).standard_normal(len(x_pr))

    def run(device):
        # The block engine on both devices: the kernels on the card, their
        # plain versions on the CPU. (The sequential engine's posterior
        # inverts the dynamics by a Cholesky solve where the block engine
        # takes the adjugate: Q_rev, a difference of nearly equal
        # covariances at short steps, then differs in its last digits, and
        # the samples, through chol(Q_rev + 1e-9 I), by ~1e-9.)
        fx = to_sde(_composite_gp("sum3"), ArrayStorage(torch.float64), device=device)(x, 0.2)
        fxp = tpost.posterior(fx, y)(torch.as_tensor(x_pr, device=device), 0.1)
        tk.reset_launch_counts()
        lml = tpost.logpdf(fxp, y_pr, engine="block").item()
        counts = tk.launch_counts()
        post, idx = tpost._merged_posterior(fxp, "block")
        eps = _eps(len(post), 3)
        sample = tlgssm.rand_with_eps(post, *(e.to(device) for e in eps), engine="block")[idx]
        return lml, sample.cpu().numpy(), counts

    lml, sample, counts = run(cuda_device)
    # The merged posterior's filter, then the reverse model's.
    assert counts["phase1_aggregate_streamed"] == counts["phase2_starts"] == 2
    assert counts["phase3_states_streamed"] == counts["phase3_lml_streamed"] == 1
    assert counts["phase1_aggregate"] == counts["phase3_lml"] == counts["phase3_states"] == 0
    lml_cpu, sample_cpu, _ = run("cpu")
    np.testing.assert_allclose(lml, lml_cpu, rtol=1e-10)
    np.testing.assert_allclose(sample, sample_cpu, rtol=1e-8,
                               atol=1e-8 * np.abs(sample_cpu).max())
    tk.reset_launch_counts()
    fx = to_sde(_composite_gp("sum3"), device=cuda_device)(x, 0.2)
    draw = tpost.rand(torch.Generator(device=cuda_device).manual_seed(1),
                      tpost.posterior(fx, y)(torch.as_tensor(x_pr, device=cuda_device), 0.1))
    counts = tk.launch_counts()
    assert draw.shape == (len(x_pr),) and bool(torch.isfinite(draw).all())
    assert [counts[n] for n in _STATE_KERNELS[3:]] == [1, 1, 1]


@pytest.mark.cuda
def test_posterior_of_a_reverse_ordered_model_takes_the_sequential_engine(cuda_device):
    """lgssm.posterior with engine=None of a reverse-ordered model (a
    posterior LGSSM conditioned again) on the card: the block posterior
    takes forward-ordered models only, so None picks the sequential engine
    there, and the smoother agrees with the CPU's within 1e-10 of each
    leaf's largest entry (the first posterior on the kernels, on the CPU on
    their plain versions)."""
    N = 300
    rng = np.random.default_rng(13)
    y, y2 = rng.standard_normal(N), rng.standard_normal(N)
    x = tt.RegularSpacing(0.0, 0.01, N)

    def run(device):
        fx = to_sde(_composite_gp("sum3"), ArrayStorage(torch.float64), device=device)(x, 0.2)
        post = tlgssm.posterior(build_lgssm(fx), torch.as_tensor(y, device=device),
                                engine="block")
        assert not post.trans.forward
        again = tlgssm.posterior(post, torch.as_tensor(y2, device=device))
        t = again.trans
        return [v.cpu() for v in (t.As, t.offs, t.Qs, t.x0.mean, t.x0.cov)], t.forward

    got, forward = run(cuda_device)
    assert forward
    want, _ = run("cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10 * w.abs().max().item())


def _c2_model_fn(device, N):
    """c2's builder, (s2 * Matern52()).stretch(sc) with noise, float64, on
    RegularSpacing(0, 1e-3, N)."""
    def model_fn(p):
        s2, sc, noise = torch.exp(p)
        return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)), device=device)(
            tt.RegularSpacing(0.0, 1e-3, N), noise))

    return model_fn


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["block", "parallel"])
def test_value_and_grad_fisher_on_card_matches_cpu(cuda_device, engine):
    """value_and_grad_fisher of c2's builder at N = 2000 with NaNs, float64.
    engine="block" launches K1-K3 for the value, then K1, K2, K7 (the
    filter) and K8-K10 (the latent marginals of the posterior inverted from
    it); "parallel" K1-K3 only. Value and gradient within 1e-10 and 1e-8 of the
    CPU port, the gradient within 1e-6 of the forward mode's (K4-K6)."""
    from temporalgps_torch.learning import value_and_grad_fisher

    N = 2000
    y = np.random.default_rng(12).standard_normal(N)
    y[[0, 17, N - 1]] = np.nan
    p0 = torch.tensor([0.1, -0.2, math.log(0.1)], dtype=torch.float64)
    tk.reset_launch_counts()
    v, g = value_and_grad_fisher(_c2_model_fn(cuda_device, N), y, engine=engine)(
        p0.to(cuda_device))
    counts = {name: n for name, n in tk.launch_counts().items() if n}
    want = {"phase1_aggregate": 1, "phase2_starts": 1, "phase3_lml": 1}
    if engine == "block":
        want = {"phase1_aggregate": 2, "phase2_starts": 2, "phase3_lml": 1, "phase3_states": 1,
                "affine_phase1": 1, "affine_phase2_starts": 1, "affine_phase3_states": 1}
    assert counts == want
    v_c, g_c = value_and_grad_fisher(_c2_model_fn("cpu", N), y, engine=engine)(p0)
    np.testing.assert_allclose(v.item(), v_c.item(), rtol=1e-10)
    np.testing.assert_allclose(g.cpu().numpy(), g_c.numpy(), rtol=1e-8)
    _, g_fwd = tt.value_and_grad_fwd_lgssm(_c2_model_fn(cuda_device, N), y)(p0.to(cuda_device))
    np.testing.assert_allclose(g.cpu().numpy(), g_fwd.cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("times", ["regular", "irregular"])
def test_block_phase2_sqrt_on_card_launches_k1_and_k3(cuda_device, times):
    """block logpdf with phase2="sqrt" on the card, float64, N = 2000 with
    NaNs: K1 and K3 (the streamed forms for irregular times) once each around
    the square-root phase 2, no K2; value within 1e-10 of the CPU port and
    of the covariance-form phase 2."""
    N = 2000
    rng = np.random.default_rng(15)
    t = np.cumsum(rng.uniform(0.5e-3, 1.5e-3, N)) if times == "irregular" else None
    y = rng.standard_normal(N)
    y[[0, 9, N - 1]] = np.nan

    def run(device, **kwargs):
        x = (tt.RegularSpacing(0.0, 1e-3, N) if t is None
             else torch.as_tensor(t, device=device))
        model = build_lgssm(to_sde(GP(1.3 * Matern52()), device=device)(x, 0.1))
        model_f, y_f, _ = tmissings.transform_model_and_obs(model, torch.as_tensor(y, device=device))
        tk.reset_launch_counts()
        lml = tlgssm.logpdf(model_f, y_f, engine="block", **kwargs)
        counts = {name: n for name, n in tk.launch_counts().items() if n}
        return lml.item(), counts

    v, counts = run(cuda_device, phase2="sqrt")
    suffix = "_streamed" if times == "irregular" else ""
    assert counts == {f"phase1_aggregate{suffix}": 1, f"phase3_lml{suffix}": 1}
    v_c, _ = run("cpu", phase2="sqrt")
    v_cov, _ = run(cuda_device)
    np.testing.assert_allclose([v, v], [v_c, v_cov], rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["parallel", "sqrt"])
def test_alternative_engines_on_card_match_cpu(cuda_device, engine):
    """engine="parallel" and "sqrt" on the card (tensor ops, no kernel):
    logpdf, the filter and the posterior's leaves of c2's model at N = 2000,
    float64, within 1e-10 of the CPU port, relative to the largest entry."""
    N = 2000
    y = np.random.default_rng(13).standard_normal(N)

    def run(device):
        model = build_lgssm(to_sde(GP(Matern52()), device=device)(
            tt.RegularSpacing(0.0, 1e-3, N), 0.1))
        yy = torch.as_tensor(y, device=device)
        xf = tlgssm.filter_(model, yy, engine=engine)
        post = tlgssm.posterior(model, yy, engine=engine)
        return [tlgssm.logpdf(model, yy, engine=engine).reshape(1), xf.mean, xf.cov,
                post.trans.As, post.trans.offs, post.trans.Qs]

    tk.reset_launch_counts()
    got = run(cuda_device)
    assert sum(tk.launch_counts().values()) == 0
    for a, b in zip(got, run("cpu")):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10 * b.abs().max().item())


@pytest.mark.cuda
def test_block_posterior_of_a_reverse_model_on_card_matches_cpu(cuda_device):
    """c2's posterior (reverse-ordered, from K1, K2, K7 and the reversal)
    conditioned again with engine="block", float64, N = 2000: the
    associative engine, no kernel launched; its leaves within 1e-10 of the
    CPU port's and within 1e-9 of the CPU's sequential engine's, relative to
    the largest entry."""
    N = 2000
    y = np.random.default_rng(14).standard_normal(N)
    y[[3, N - 1]] = np.nan

    def run(device, engine):
        model = build_lgssm(to_sde(GP(Matern52()), device=device)(
            tt.RegularSpacing(0.0, 1e-3, N), 0.1))
        model_f, y_f, _ = tmissings.transform_model_and_obs(model, torch.as_tensor(y, device=device))
        post = tlgssm.posterior(model_f, y_f, engine=engine)
        if device != "cpu":
            tk.reset_launch_counts()
        again = tlgssm.posterior(post, y_f, engine=engine)
        t = again.trans
        assert t.forward
        return [t.As, t.offs, t.Qs, t.x0.mean, t.x0.cov]

    got = run(cuda_device, "block")
    assert sum(tk.launch_counts().values()) == 0
    for engine, rtol in (("block", 1e-10), ("sequential", 1e-9)):
        for a, b in zip(got, run("cpu", engine)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=rtol,
                                       atol=rtol * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["sequential", "block", "parallel"])
def test_space_time_grid_on_card_matches_cpu(cuda_device, engine):
    """c4's model (Separable(EQ().stretch(0.7), Matern52()), noise 0.1) on a
    10 x 50 grid (D = 30, Dout = 10), one NaN, float64: logpdf, the
    posterior marginals at the training inputs and at 20 new times, and
    rand_with_eps on the same normals, on the card within 1e-10 of the CPU
    port's same engine; no kernel launched (the matrix path)."""
    from temporalgps_torch.gp import EQ
    from temporalgps_torch.space_time import RectilinearGrid, Separable

    ns, nt = 10, 50
    rng = np.random.default_rng(15)
    y = rng.standard_normal(ns * nt)
    y[17] = np.nan
    t_new = np.sort(rng.uniform(0.0, 0.6, 20))
    D = 3 * ns
    eps = [rng.standard_normal(s) for s in ((nt, D), (nt, ns), (D,))]

    def run(device):
        grid = lambda t: RectilinearGrid(torch.linspace(-3, 3, ns, dtype=torch.float64,
                                                        device=device), t)
        fx = to_sde(GP(Separable(EQ().stretch(0.7), Matern52())), device=device)(
            grid(tt.RegularSpacing(0.0, 0.01, nt)), 0.1)
        fp = tpost.posterior(fx, y)
        out = [tt.logpdf(fx, y, engine=engine).reshape(1)]
        out += tpost.marginals(fp(fx.x, 0.1), engine=engine)
        out += tpost.marginals(fp(grid(torch.as_tensor(t_new, device=device)), 0.1),
                               engine=engine)
        out.append(tlgssm.rand_with_eps(build_lgssm(fx), *(torch.as_tensor(e, device=device)
                                                           for e in eps), engine=engine))
        return [t.cpu() for t in out]

    tk.reset_launch_counts()
    got = run(cuda_device)
    assert sum(tk.launch_counts().values()) == 0
    for a, b in zip(got, run("cpu")):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10 * b.abs().max().item())


@pytest.mark.cuda
def test_kron_on_card_matches_cpu(cuda_device):
    """c4's model (Separable(EQ().stretch(0.7), Matern52()), noise 0.1) on
    an 8 x 25 grid, one NaN, float64, engine="kron": logpdf, the prior
    marginals, the posterior marginals at the training inputs and at 9 new
    times, rand_with_eps on the same normals and the autograd gradient of
    logpdf, on the card within 1e-9 of the CPU port; no kernel launched."""
    from temporalgps_torch.gp import EQ
    from temporalgps_torch.space_time import RectilinearGrid, Separable, kron

    ns, nt = 8, 25
    rng = np.random.default_rng(19)
    y = rng.standard_normal(ns * nt)
    y[17] = np.nan
    t_new = np.sort(rng.uniform(0.0, 0.3, 9))
    eps = [rng.standard_normal(s) for s in ((3, ns), (nt, 3, ns), (nt, ns))]

    def run(device):
        grid = lambda t: RectilinearGrid(torch.linspace(-3, 3, ns, dtype=torch.float64,
                                                        device=device), t)
        s2 = torch.tensor(1.3, dtype=torch.float64, device=device, requires_grad=True)
        fx = to_sde(GP(s2 * Separable(EQ().stretch(0.7), Matern52())), device=device)(
            grid(tt.RegularSpacing(0.0, 0.01, nt)), 0.1)
        lml = tt.logpdf(fx, y, engine="kron")
        fp = tpost.posterior(fx, y)
        out = [lml.detach().reshape(1), torch.autograd.grad(lml, s2)[0].reshape(1)]
        out += tt.marginals(fx, engine="kron")
        out += tpost.marginals(fp(fx.x, 0.1), engine="kron")
        out += tpost.marginals(fp(grid(torch.as_tensor(t_new, device=device)), 0.1),
                               engine="kron")
        out.append(kron.rand_with_eps(fx, *(torch.as_tensor(e, device=device) for e in eps)))
        return [t.detach().cpu() for t in out]

    tk.reset_launch_counts()
    got = run(cuda_device)
    assert sum(tk.launch_counts().values()) == 0
    for a, b in zip(got, run("cpu")):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9 * b.abs().max().item())
