"""The port's state-emitting phases (K7 phase3_states and the affine phases
K8-K10, plain PyTorch versions) against the reference package's XLA block
schedules, on the CPU.

The reference runs `block.filter_`, `block.affine_prefix_states` and
`block.latent_marginals` (its XLA schedules of the same blocked algorithm),
never interpret-mode Pallas. Same blocking (B blocks of L = ceil(N / B)
steps, a padded tail), float64: rtol 1e-10 with an absolute floor of 1e-10
of each array's largest entry, for entries that cancel to ~0. The CUDA
kernels are held to these plain versions on the card by
tests/test_torch_card.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import lgssm as jlgssm
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock

from temporalgps_torch import convert
from temporalgps_torch.models.emissions import ScalarEmissions
from temporalgps_torch.models.gauss_markov import GaussMarkov
from temporalgps_torch.models.lgssm import LGSSM
from temporalgps_torch.ops import block as tblock
from temporalgps_torch.ops import kernels as tk
from temporalgps_torch.utils.fill import Fill, tmaterialize
from temporalgps_torch.utils.gaussian import Gaussian

torch.set_num_threads(1)

KERNEL_OF_DIM = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
N, B, NAN_AT = 23, 4, 9  # 4 blocks of 6 steps: one padding step, one missing value

_filter_ref = jax.jit(jblock.filter_, static_argnames=("n_blocks",))
_prefix_ref = jax.jit(jblock.affine_prefix_states, static_argnames=("n_blocks",))
_latent_ref = jax.jit(jblock.latent_marginals, static_argnames=("n_blocks",))
_posterior_ref = jax.jit(functools.partial(jlgssm.posterior, engine="sequential"))
_transform_ref = jax.jit(jmissings.transform_model_and_obs)


def _close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        np.asarray(actual), desired, rtol=1e-10, atol=1e-10 * np.abs(desired).max()
    )


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


@functools.cache
def _prior_model(D, n=N):
    kern = getattr(jgp, KERNEL_OF_DIM[D])
    fx = jgp.to_sde(jgp.GP((1.3 * kern()).stretch(0.7)))(JRegularSpacing(0.0, 0.3, n), 0.2)
    return jax.jit(lambda: japi.build_lgssm(fx))()


def _reference_model(D, seed, n=N, missing=(NAN_AT,)):
    """The reference model on n steps after the missing-data transform (y
    missing at `missing`), its filled y, and the port's model carried across
    from the same values."""
    y = np.random.default_rng(seed).standard_normal(n)
    y[list(missing)] = np.nan
    model, y_f, _ = _transform_ref(_prior_model(D, n), jnp.asarray(y))
    return model, y_f, _carry(model, forward=True, n=n)


def _carry(model, forward, n=N):
    t, e = model.trans, model.emis
    val = lambda leaf: getattr(leaf, "value", leaf)
    return convert.lgssm_from_numpy(
        *(np.asarray(val(leaf)) for leaf in (t.As, t.offs, t.Qs, e.H, e.h, e.s)),
        np.asarray(t.x0.mean), np.asarray(t.x0.cov), n,
        dtype=torch.float64, device="cpu", forward=forward)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_phase3_states_plain_matches_reference_filter(D):
    """K1 -> K2 -> K7 (plain) give the reference block filter's states."""
    model, y_f, tmodel = _reference_model(D, seed=D)
    want = _filter_ref(model, y_f, n_blocks=B)
    comps = tblock._filter_state_comps(tmodel, _t(y_f), B, fused=False)
    assert comps.shape == (tk.state_rows(D), N)
    got = tblock._comps_to_gaussian(comps, D)
    _close(got.mean, want.mean)
    _close(got.cov, want.cov)


# K7's chunked schedule: L = 1 (fewer steps than chunks), 5 and 37 (neither
# a multiple of the chunk count) steps a block, with a padded tail (n = 4L -
# 2, or 3 for L = 1), and missing steps on both sides of a chunk boundary of
# both chunk counts in block 1: its step BOUNDARY[L] starts a run of 4 and
# of 16 runs, so the run before it ends missing and the run from it starts
# missing.
STATE_CHUNK_LENGTHS = {1: 3, 5: 18, 37: 146}
BOUNDARY = {1: 0, 5: 2, 37: 30}


@pytest.mark.parametrize("chunks", [4, tk.PHASE3_STATES_CHUNKS])
@pytest.mark.parametrize("L", sorted(STATE_CHUNK_LENGTHS))
@pytest.mark.parametrize("D", [1, 3])
def test_phase3_states_plain_chunked_matches_serial_and_reference_filter(D, L, chunks):
    """K7's schedule (each run folded, its start formed from the block start
    and the earlier runs' aggregates, then replayed) gives the serial
    replay's states, and after K1 -> K2 the reference block filter's."""
    n = STATE_CHUNK_LENGTHS[L]
    at = L + BOUNDARY[L]
    model, y_f, tmodel = _reference_model(D, seed=60 + L, n=n, missing=(at - 1, at))
    want = _filter_ref(model, y_f, n_blocks=B)
    t, e = tmodel.trans, tmodel.emis
    y_main, s_main, _ = tblock._blocked_streams(_t(y_f), tmaterialize(e.s), B)
    assert y_main.shape == (L, B) and L * B > n
    Lc = -(-L // chunks)
    assert (L == 1 or BOUNDARY[L] % Lc == 0) and bool((s_main[BOUNDARY[L], 1] > 1e14))
    packed = tk.pack_params(t.As.value, t.offs.value, t.Qs.value, e.H.value, e.h.value,
                            torch.float64)
    aggs = tk.phase1_aggregate_plain(y_main, s_main, packed, D)
    starts = tk.phase2_starts_plain(aggs, t.x0.mean, 0.5 * (t.x0.cov + t.x0.cov.T), D)
    chunked = tk.phase3_states_plain(y_main, s_main, packed, starts, D, chunks=chunks)
    _close(chunked, tk.phase3_states_plain(y_main, s_main, packed, starts, D))
    got = tblock._comps_to_gaussian(tblock._unblock_states(chunked, n), D)
    _close(got.mean, want.mean)
    _close(got.cov, want.cov)


def _affine_inputs(D, seed, n=N):
    """Time-varying (F, c, Q) in iteration order and an initial state, from
    numpy: stable maps, positive semi-definite noise."""
    rng = np.random.default_rng(seed)
    F = 0.9 * np.eye(D) + 0.05 * rng.standard_normal((n, D, D))
    c = 0.1 * rng.standard_normal((n, D))
    G = 0.2 * rng.standard_normal((n, D, D))
    Q = np.einsum("nij,nkj->nik", G, G)
    m0 = rng.standard_normal(D)
    P0 = np.eye(D) + 0.1 * np.ones((D, D))
    return F, c, Q, m0, P0


def _affine_case(D, seed, n=N):
    """(reference prefix states, initial state, the port's (KT, L, B) rows)
    of time-varying maps on n steps in B blocks."""
    F, c, Q, m0, P0 = _affine_inputs(D, seed, n)
    want = _prefix_ref(*(jnp.asarray(v) for v in (F, c, Q, m0, P0)), n_blocks=B)
    x0 = Gaussian(_t(m0), _t(P0))
    dummy = Fill(torch.zeros((), dtype=torch.float64), n)
    tmodel = LGSSM(GaussMarkov(As=_t(F), offs=_t(c), Qs=_t(Q), x0=x0),
                   ScalarEmissions(H=Fill(torch.ones(D, dtype=torch.float64), n), h=dummy, s=dummy))
    return want, x0, tblock._affine_comps_iteration(tmodel, B)


def _check_affine_phases(want, x0, params, agg, D, n=N):
    """K9 -> K10 (plain) from the aggregates `agg` give the reference's
    states; K9's starts and the aggregates are checked on their own against
    folds of the same maps."""
    L = params.shape[1]
    m0, P0 = x0.mean.numpy(), x0.cov.numpy()
    starts = tk.affine_phase2_starts_plain(agg, x0.mean, x0.cov, D)
    states = tblock._unblock_states(tk.affine_phase3_states_plain(params, starts, D), n)
    got = tblock._comps_to_gaussian(states, D)
    _close(got.mean, want.mean)
    _close(got.cov, want.cov)

    # Block b starts from the state after block b-1 (x0 for block 0), and
    # its aggregate maps that start to the state after its last step.
    ends = slice(L - 1, (B - 1) * L, L)
    m_start = np.concatenate([m0[None], np.asarray(want.mean)[ends]])
    P_start = np.concatenate([P0[None], np.asarray(want.cov)[ends]])
    _close(starts[:D].T, m_start)
    _close(starts[D:].T.reshape(B, D, D), P_start)
    A_agg, b_agg = agg[:D * D].T.reshape(B, D, D).numpy(), agg[D * D:D * D + D].T.numpy()
    C_agg = agg[D * D + D:].T.reshape(B, D, D).numpy()
    full = slice(0, B - 1)  # the blocks without padding
    m_end = np.einsum("bij,bj->bi", A_agg[full], m_start[full]) + b_agg[full]
    P_end = A_agg[full] @ P_start[full] @ A_agg[full].transpose(0, 2, 1) + C_agg[full]
    _close(m_end, np.asarray(want.mean)[L - 1::L][:B - 1])
    _close(P_end, np.asarray(want.cov)[L - 1::L][:B - 1])


@pytest.mark.parametrize("D", [1, 2, 3])
def test_affine_phases_plain_match_reference_prefix(D):
    """K8 -> K9 -> K10 (plain) give the states of the reference's blocked
    affine prefix on time-varying maps; K8's aggregates and K9's starts are
    checked on their own against folds of the same maps."""
    want, x0, params = _affine_case(D, seed=10 + D)
    L = params.shape[1]
    assert params.shape == (tk.affine_rows(D), L, B) and L * B > N
    _check_affine_phases(want, x0, params, tk.affine_phase1_plain(params, D), D)


# K8's chunked schedule: L = 1 (fewer steps than chunks), 5 and 37 (neither
# a multiple of the chunk count) steps a block, each with a padded tail of
# identity maps (n = 4L - 2, or 3 for L = 1).
CHUNK_LENGTHS = {1: 3, 5: 18, 37: 146}


@pytest.mark.parametrize("chunks", [4, tk.AFFINE_PHASE1_CHUNKS])
@pytest.mark.parametrize("L", sorted(CHUNK_LENGTHS))
@pytest.mark.parametrize("D", [1, 3])
def test_affine_phase1_plain_chunked_matches_serial_and_reference_prefix(D, L, chunks):
    """The kernel's schedule (each block's maps in `chunks` runs, the run
    aggregates combined in order, empty runs the identity map) gives the
    serial fold's aggregates, and through K9 and K10 the reference's
    blocked affine prefix."""
    n = CHUNK_LENGTHS[L]
    want, x0, params = _affine_case(D, seed=40 + D, n=n)
    assert params.shape == (tk.affine_rows(D), L, B) and L * B > n
    chunked = tk.affine_phase1_plain(params, D, chunks=chunks)
    _close(chunked, tk.affine_phase1_plain(params, D))
    _check_affine_phases(want, x0, params, chunked, D, n)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_latent_marginals_plain_match_reference_on_a_reverse_model(D):
    """The reference's smoothing posterior (reverse-ordered, per-step
    leaves) carried across: the affine block schedule's latent marginals,
    through the flip and identity shift of the iteration view, match the
    reference's block.latent_marginals; the forward prior's match too."""
    model, y_f, tmodel = _reference_model(D, seed=20 + D)
    post = _posterior_ref(model, y_f)
    tpost = _carry(post, forward=False)
    for ref, port in ((post, tpost), (model, tmodel)):
        want = _latent_ref(ref, n_blocks=B)
        got = tblock.latent_marginals(port, n_blocks=B, fused=False)
        _close(got.mean, want.mean)
        _close(got.cov, want.cov)


def test_state_wrappers_on_cpu_run_the_plain_versions():
    D = 2
    model, y_f, tmodel = _reference_model(D, seed=30)
    tk.reset_launch_counts()
    fused = tblock._filter_state_comps(tmodel, _t(y_f), B, fused=True)
    plain = tblock._filter_state_comps(tmodel, _t(y_f), B, fused=False)
    assert torch.equal(fused, plain)
    assert torch.equal(tblock.latent_marginal_comps(tmodel, n_blocks=B, fused=True),
                       tblock.latent_marginal_comps(tmodel, n_blocks=B, fused=False))
    assert all(n == 0 for n in tk.launch_counts().values())
