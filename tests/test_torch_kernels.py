"""The port's block-filter phases (temporalgps_torch/ops/kernels.py) against
the reference package's XLA block schedule, component by component.

The plain PyTorch versions run here on the CPU; the reference runs its plain
references (_phase1_aggregates_lanes, _phase2_prefix, _phase3_lml_lanes),
never interpret-mode Pallas. Same algorithm, same blocking, float64: rtol
1e-10, with an absolute floor of 1e-10 of each array's largest entry for
entries that cancel to ~0. The CUDA kernels themselves are tested on the
card by tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock
from temporalgps_tpu.ops import lanes as jlanes
from temporalgps_tpu.utils.gaussian import Gaussian as JGaussian

from temporalgps_torch.ops import block as tblock
from temporalgps_torch.ops import kernels as tk

torch.set_num_threads(1)

KERNEL_OF_DIM = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
N, B, NAN_AT = 18, 4, 7  # 4 blocks of 5 steps: 2 padding steps, one missing value

_phase1_ref = jax.jit(jblock._phase1_aggregates_lanes, static_argnums=(1, 2, 3))
_phase2_ref = jax.jit(lambda elems: jblock._phase2_prefix(elems, None))
_phase3_ref = jax.jit(jblock._phase3_lml_lanes, static_argnums=(2, 3, 4))


def _close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        np.asarray(actual), desired, rtol=1e-10, atol=1e-10 * np.abs(desired).max()
    )


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _reference_setup(D, seed, n=N):
    """The reference model on n steps after the missing-data transform,
    padded and cut into B blocks; plus the port's streams and packed
    parameters built from the same numpy values."""
    y = np.random.default_rng(seed).standard_normal(n)
    y[min(NAN_AT, n // 2)] = np.nan
    kern = getattr(jgp, KERNEL_OF_DIM[D])
    fx = jgp.to_sde(jgp.GP((1.3 * kern()).stretch(0.7)))(JRegularSpacing(0.0, 0.3, n), 0.2)
    model, y_f, _ = jmissings.transform_model_and_obs(japi.build_lgssm(fx), jnp.asarray(y))
    params_p, y_p, s_p, n_pad, _ = jblock._pad_tail(model, y_f, B)
    L = (n + n_pad) // B
    blocked = jblock._split_tree((params_p, y_p), B, L)

    t = model.trans
    y_main, s_main, _ = tblock._blocked_streams(_t(y_f), _t(model.emis.s), B)
    packed = tk.pack_params(
        _t(t.As.value), _t(t.offs.value), _t(t.Qs.value),
        _t(model.emis.H.value), _t(model.emis.h.value), torch.float64,
    )
    return model, blocked, y_p, s_p, y_main, s_main, packed


def _elem_from_rows(rows, D):
    """(K, B) component rows -> the reference's (A, b, C, eta, J) arrays."""
    rows = np.asarray(rows)
    DD = D * D
    Bn = rows.shape[1]
    return (
        rows[:DD].T.reshape(Bn, D, D),
        rows[DD:DD + D].T,
        rows[DD + D:2 * DD + D].T.reshape(Bn, D, D),
        rows[2 * DD + D:2 * DD + 2 * D].T,
        rows[2 * DD + 2 * D:].T.reshape(Bn, D, D),
    )


@pytest.mark.parametrize("D", [1, 2, 3])
def test_blocked_streams_match_reference_padding(D):
    _model, _blocked, y_p, s_p, y_main, s_main, _packed = _reference_setup(D, seed=D)
    L = y_main.shape[0]
    _close(y_main.numpy(), np.asarray(y_p).reshape(B, L).T)
    _close(s_main.numpy(), np.asarray(s_p).reshape(B, L).T)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_phase1_plain_matches_reference(D):
    model, blocked, _y_p, _s_p, y_main, s_main, packed = _reference_setup(D, seed=10 + D)
    agg_ref = _phase1_ref(blocked, B, D, jnp.float64)
    comps = tk.phase1_aggregate_plain(y_main, s_main, packed, D)
    assert comps.shape == (tk.elem_rows(D), B)
    for got, want in zip(_elem_from_rows(comps, D), agg_ref):
        _close(got, want)


# K1's chunked schedule: L = 1 (fewer steps than chunks), 5 and 37 (neither
# a multiple of the chunk count) steps a block, each with a missing
# observation and a padded tail (n = 4L - 2, or 3 for L = 1).
CHUNK_LENGTHS = {1: 3, 5: N, 37: 146}


@pytest.mark.parametrize("chunks", [4, tk.PHASE1_AGGREGATE_CHUNKS])
@pytest.mark.parametrize("L", sorted(CHUNK_LENGTHS))
@pytest.mark.parametrize("D", [1, 3])
def test_phase1_plain_chunked_matches_serial_and_reference(D, L, chunks):
    """The kernel's schedule (each block's steps in `chunks` runs, the run
    aggregates combined in order, empty runs the identity) gives the serial
    fold's aggregates and the reference's, and downstream the reference's
    block starts (K2) and lml (K3)."""
    n = CHUNK_LENGTHS[L]
    model, blocked, _y_p, _s_p, y_main, s_main, packed = _reference_setup(D, seed=50 + L, n=n)
    assert y_main.shape == (L, B) and L * B > n
    chunked = tk.phase1_aggregate_plain(y_main, s_main, packed, D, chunks=chunks)
    _close(chunked, tk.phase1_aggregate_plain(y_main, s_main, packed, D))
    agg_ref = _phase1_ref(blocked, B, D, jnp.float64)
    for got, want in zip(_elem_from_rows(chunked, D), agg_ref):
        _close(got, want)

    x0 = model.trans.x0
    prior = jblock._prior_element(x0, D, jnp.float64)
    pref = _phase2_ref(tuple(jnp.concatenate([p, a]) for p, a in zip(prior, agg_ref)))
    P0 = _t(x0.cov)
    starts = tk.phase2_starts_plain(chunked, _t(x0.mean), 0.5 * (P0 + P0.T), D)
    _close(starts[:D].T, pref[1][:-1])
    _close(starts[D:].T.reshape(B, D, D), pref[2][:-1])
    lml = tk.phase3_lml_plain(y_main, s_main, packed, starts, D).sum()
    _close(lml, _phase3_ref(blocked, JGaussian(pref[1][:-1], pref[2][:-1]), B, D, jnp.float64))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_phase2_plain_matches_reference(D):
    model, blocked, *_ = _reference_setup(D, seed=20 + D)
    agg_ref = _phase1_ref(blocked, B, D, jnp.float64)
    x0 = model.trans.x0
    prior = jblock._prior_element(x0, D, jnp.float64)
    pref = _phase2_ref(tuple(jnp.concatenate([p, a]) for p, a in zip(prior, agg_ref)))
    comps = torch.cat([
        _t(agg_ref[0]).reshape(B, -1).T, _t(agg_ref[1]).T,
        _t(agg_ref[2]).reshape(B, -1).T, _t(agg_ref[3]).T,
        _t(agg_ref[4]).reshape(B, -1).T,
    ]).contiguous()
    P0 = _t(x0.cov)
    starts = tk.phase2_starts_plain(comps, _t(x0.mean), 0.5 * (P0 + P0.T), D)
    assert starts.shape == (tk.state_rows(D), B)
    _close(starts[:D].T, pref[1][:-1])
    _close(starts[D:].T.reshape(B, D, D), pref[2][:-1])


@pytest.mark.parametrize("D", [1, 2, 3])
def test_phase3_plain_matches_reference(D):
    model, blocked, y_p, s_p, y_main, s_main, packed = _reference_setup(D, seed=30 + D)
    agg_ref = _phase1_ref(blocked, B, D, jnp.float64)
    prior = jblock._prior_element(model.trans.x0, D, jnp.float64)
    pref = _phase2_ref(tuple(jnp.concatenate([p, a]) for p, a in zip(prior, agg_ref)))
    m0, P0 = pref[1][:-1], pref[2][:-1]
    starts = torch.cat([_t(m0).T, _t(P0).reshape(B, -1).T]).contiguous()
    partials = tk.phase3_lml_plain(y_main, s_main, packed, starts, D)
    assert partials.shape == (B,)
    total_ref = _phase3_ref(blocked, JGaussian(m0, P0), B, D, jnp.float64)
    _close(partials.sum(), total_ref)

    # Per block: the reference's lane-major Kalman step, run eagerly.
    t, e = model.trans, model.emis
    A = jlanes.decompose_mat(t.As.value, D)
    a = jlanes.decompose_vec(t.offs.value, D)
    Q = jlanes.decompose_mat(t.Qs.value, D)
    H = jlanes.decompose_vec(e.H.value, D)
    L = y_main.shape[0]
    y_blk = jnp.asarray(y_p).reshape(B, L).T
    s_blk = jnp.asarray(s_p).reshape(B, L).T
    m = tuple(m0[:, i] for i in range(D))
    P = tuple(tuple(P0[:, i, j] for j in range(D)) for i in range(D))
    acc = jnp.zeros(B)
    for l in range(L):
        m, P, lml = jlanes.kalman_step(m, P, A, a, Q, H, e.h.value, s_blk[l], y_blk[l])
        acc = acc + lml
    _close(partials, acc)


def test_wrappers_on_cpu_run_the_plain_versions():
    _model, _blocked, _y, _s, y_main, s_main, packed = _reference_setup(3, seed=40)
    D = 3
    x0_mean, x0_cov = torch.zeros(D, dtype=torch.float64), torch.eye(D, dtype=torch.float64)
    tk.reset_launch_counts()
    comps = tk.phase1_aggregate(y_main, s_main, packed, D)
    starts = tk.phase2_starts(comps, x0_mean, x0_cov, D)
    lml = tk.phase3_lml(y_main, s_main, packed, starts, D)
    assert torch.equal(comps, tk.phase1_aggregate_plain(y_main, s_main, packed, D))
    assert torch.equal(starts, tk.phase2_starts_plain(comps, x0_mean, x0_cov, D))
    assert torch.equal(lml, tk.phase3_lml_plain(y_main, s_main, packed, starts, D))
    assert tk.launch_counts() == dict.fromkeys(
        ("phase1_aggregate", "phase2_starts", "phase3_lml",
         "phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml",
         "phase3_states", "affine_phase1", "affine_phase2_starts", "affine_phase3_states"), 0)


def test_wrappers_refuse_devices_without_a_kernel():
    y = torch.zeros((5, 4), dtype=torch.float64, device="meta")
    packed = torch.zeros(tk.param_len(2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.phase1_aggregate(y, y, packed, 2)
    with pytest.raises(ValueError, match="several devices"):
        tk.phase1_aggregate(y, torch.zeros((5, 4), dtype=torch.float64), packed, 2)


@pytest.mark.parametrize(
    "D, dtype, contiguous, error",
    [
        (4, torch.float64, True, ValueError),
        (2, torch.float16, True, TypeError),
        (2, torch.float64, False, ValueError),
    ],
)
def test_kernel_argument_checks(D, dtype, contiguous, error):
    y = torch.zeros((4, 6), dtype=dtype)
    if not contiguous:
        y = y.T
    with pytest.raises(error):
        tk._check_kernel_args(D, y)


def test_failed_nvcc_raises_with_its_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        tk.build()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk._nvcc()
