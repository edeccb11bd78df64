"""The block-parallel Kalman filter's three phases (csrc/block_phases.cu),
their forward-mode twins, which carry k tangents beside the primal
(csrc/block_phases_jvp.cu), and the state-emitting phases of smoothing and
prediction (csrc/block_states.cu), as kernels written by hand for Hopper,
each beside its plain PyTorch version.

Layout, as in temporalgps_tpu/ops/pallas_kernels.py: B blocks of L steps;
y and s are (L, B) streams (row l holds step l of every block); elements and
states are component-major, (rows, B):

    element rows (K = 3D^2 + 2D):  A (D*D, row-major), b (D), C (D*D), eta (D), J (D*D)
    state rows   (SD = D + D^2):   m (D), P (D*D, row-major)
    packed params (PK = 2D^2 + 2D + 1):  A (D*D), a (D), Q (D*D), H (D), h
    affine rows   (KT = 2D^2 + D):  A (D*D), b (D), C (D*D)

The state-emitting phases write the state after every step as (SD, L, B):
out[:, l, b] is the state after step l of block b. The affine phases take
time-varying maps x -> A x + b + N(0, C) as (KT, L, B) rows.

The forward-mode phases take (1+k, PK2) parameter rows, PK2 = PK + 1: row 0
the packed primal parameters, row 1+j their tangent j, the extra last slot
holding the time-invariant noise tangent (unused in row 0: the noise is
streamed). Their elements, states and lml rows are the primal set followed
by the k tangent sets: ((1+k)*K, B), ((1+k)*SD, B), (1+k, B).

K1 (phase1_aggregate), K4 (phase1_jvp) and K8 (affine_phase1) also return
the aggregates of the runs of steps their warps fold, (C, rows, B), run c
first: K3 (phase3_lml), K6 (phase3_jvp_lml) and K10 (affine_phase3_states)
start their runs from them.

K1, K3 and K7 have a second, streamed form for per-step transitions
(irregular times): `phase1_aggregate_streamed`, `phase3_lml_streamed` and
`phase3_states_streamed` take the (A, a, Q) of every step as (KT, L, B)
rows, the affine layout, padded with identity steps, and H and h from the
packed row, whose transition slots they do not read. The same kernels run
both forms (csrc/lanes.cuh, ConstantTrans and StreamedTrans), on the same
schedules; their plain versions take the rows as `trans_rows=`.

Each wrapper runs the plain version when its tensors are on the CPU, and
launches its kernel when they are on a CUDA device; there is no other route.
It counts its kernel launches in `<wrapper>.launches`.

The kernels are compiled with nvcc at first use (one nvcc per source file,
all started together) into a shared library with a plain C interface under
temporalgps_torch/_build/, keyed by a hash of the sources and flags, and
loaded with ctypes.
"""

import ctypes
import functools
import hashlib
import itertools
import operator
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import lanes

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Streamed noise at or above this marks a missing or padding step (LARGE_VAR / 10).
_MASK_THRESH = 1e14
# Chunks of each block's steps that K1, K4, K7 and K8 run side by side (one
# warp each): the kernels' kPhase1AggregateChunks, kPhase1JvpChunks,
# kPhase3StatesChunks and kAffineChunks. K3 replays K1's chunks, K6 K4's and
# K10 K8's, from their chunk aggregates, so each shares that count. Each
# launch passes its constant and the kernel refuses any other, so the plain
# versions' chunks= and the card's schedule are the same.
PHASE1_AGGREGATE_CHUNKS = 16
PHASE1_JVP_CHUNKS = 16
PHASE3_STATES_CHUNKS = 16
AFFINE_PHASE1_CHUNKS = 16
_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def elem_rows(D: int) -> int:
    return 3 * D * D + 2 * D


def state_rows(D: int) -> int:
    return D + D * D


def param_len(D: int) -> int:
    return 2 * D * D + 2 * D + 1


def param_s_len(D: int) -> int:
    return param_len(D) + 1


def affine_rows(D: int) -> int:
    return 2 * D * D + D


def pack_params(A, a, Q, H, h, dtype):
    """(PK,) tensor of the time-invariant transition and emission."""
    return torch.cat(
        [A.reshape(-1), a.reshape(-1), Q.reshape(-1), H.reshape(-1), h.reshape(1)]
    ).to(dtype)


def pack_params_s(A, a, Q, H, h, s, dtype):
    """(PK2,) tensor: pack_params plus one trailing slot for the noise."""
    return torch.cat([pack_params(A, a, Q, H, h, dtype), s.reshape(1).to(dtype)])


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _run_nvcc(commands):
    """Run the nvcc commands side by side; return their joined output, or
    raise with the stderr of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outputs = [proc.communicate() for proc in procs]
    for proc, (_out, err) in zip(procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{err}")
    return "".join(out + err for out, err in outputs)


def build() -> Path:
    """Compile csrc/*.cu into the shared library, unless a library built from
    the same sources and flags exists; return its path. Each source is
    compiled by its own nvcc, all at once, and the objects are then linked.
    The compiler's output (ptxas register and spill counts) is kept beside
    the library with suffix .log."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"libtgps_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp_path = BUILD_DIR / f"{tag}.so.tmp"
    try:
        log = _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources, objects)])
        log += _run_nvcc([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_path),
                           *map(str, objects)]])
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp_path, lib_path)
    finally:
        for path in (*objects, tmp_path):
            path.unlink(missing_ok=True)
    return lib_path


_ENTRY_ARGS = {
    # pointers, then ints, then the stream
    # K1, K3 and K7 take the (KT, L, B) transition rows of their streamed
    # forms after the packed parameters, or a null pointer for the constant ones.
    "phase1_aggregate": (6, 4),  # y, s, params, rows, out, chunk_out; L, B, D, chunks
    "phase2_starts": (3, 2),     # comps, prior, starts; B, D
    "phase3_lml": (7, 4),        # y, s, params, rows, starts, chunk_aggs, lml; L, B, D, chunks
    "phase1_jvp": (5, 5),         # y, s, rows, out, chunk_out; L, B, D, k, chunks
    "phase2_jvp_starts": (3, 3),  # comps, priors, starts; B, D, k
    "phase3_jvp_lml": (6, 5),     # y, s, rows, starts, chunk_aggs, lml; L, B, D, k, chunks
    "phase3_states": (6, 4),         # y, s, params, rows, starts, out; L, B, D, chunks
    "affine_phase1": (3, 4),         # params, out, chunk_out; L, B, D, chunks
    "affine_phase2_starts": (3, 2),  # agg, prior, starts; B, D
    "affine_phase3_states": (4, 4),  # params, starts, chunk_aggs, out; L, B, D, chunks
}


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    for name, (n_ptr, n_int) in _ENTRY_ARGS.items():
        for suffix in _DTYPE_SUFFIX.values():
            fn = getattr(lib, f"tgps_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.tgps_error_string.argtypes = [ctypes.c_int]
    lib.tgps_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, tensors, ints):
    """Call the C entry `name` for the tensors' dtype on the current stream
    (a None tensor is a null pointer); raise if the launch reports an
    error."""
    lib = _library()
    fn = getattr(lib, f"tgps_{name}_{_DTYPE_SUFFIX[tensors[0].dtype]}")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints, stream)
    if err != 0:
        msg = lib.tgps_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _route(*tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when all lie on one
    CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {device}")
    return device.type


def _check_kernel_args(D, *tensors):
    if D not in (1, 2, 3):
        raise ValueError(f"the kernels take state dimension D in 1..3, got {D}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"the kernels take float32 or float64, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"mixed dtypes: {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _prior_row(x0_mean, x0_cov, dtype):
    """(SD,) row of an initial state: m0, then row-major P0."""
    return torch.cat([x0_mean.reshape(-1), x0_cov.reshape(-1)]).to(dtype)


def _check_streams(y_blocked, s_blocked):
    if y_blocked.ndim != 2:
        raise ValueError(f"y_blocked must be (L, B), got shape {tuple(y_blocked.shape)}")
    _check_shape("s_blocked", s_blocked, y_blocked.shape)


# ---------------------------------------------------------------------------
# Plain versions: Python loops of ops/lanes.py on (B,) component tensors
# ---------------------------------------------------------------------------

def _unpack_params(packed, D):
    vals = packed.unbind(0)
    DD = D * D
    A = tuple(tuple(vals[r * D + c] for c in range(D)) for r in range(D))
    a = tuple(vals[DD + i] for i in range(D))
    Q = tuple(tuple(vals[DD + D + r * D + c] for c in range(D)) for r in range(D))
    H = tuple(vals[2 * DD + D + i] for i in range(D))
    h = vals[2 * DD + 2 * D]
    return A, a, Q, H, h


def _identity_elem(shape, D, like):
    ones, zeros = like.new_ones(shape), like.new_zeros(shape)
    zmat = tuple(tuple(zeros for _ in range(D)) for _ in range(D))
    return (lanes.eye(D, ones, zeros), (zeros,) * D, zmat, (zeros,) * D, zmat)


def _zero_elem(shape, D, like):
    zeros = like.new_zeros(shape)
    zmat = tuple(tuple(zeros for _ in range(D)) for _ in range(D))
    return (zmat, (zeros,) * D, zmat, (zeros,) * D, zmat)


def _affine_rows_to_tuple(rows, D):
    """Rows A (D*D), b (D), C (D*D) -> component tuples (A, b, C); a
    filtering element's first three components share this layout."""
    DD = D * D
    A = tuple(tuple(rows[r * D + c] for c in range(D)) for r in range(D))
    b = tuple(rows[DD + i] for i in range(D))
    C = tuple(tuple(rows[DD + D + r * D + c] for c in range(D)) for r in range(D))
    return (A, b, C)


def _elem_rows_to_tuple(rows, D):
    DD = D * D
    eta = tuple(rows[2 * DD + D + i] for i in range(D))
    J = tuple(tuple(rows[2 * DD + 2 * D + r * D + c] for c in range(D)) for r in range(D))
    return (*_affine_rows_to_tuple(rows, D), eta, J)


def _flat(M):
    """Row-major entries of a component matrix."""
    return [x for row in M for x in row]


def _elem_tuple_to_rows(e):
    A, b, C, eta, J = e
    return [*_flat(A), *b, *_flat(C), *eta, *_flat(J)]


def _state_tuple_to_rows(m, P):
    return [*m, *_flat(P)]


def _state_rows_to_tuple(rows, D):
    m = tuple(rows[:D])
    P = tuple(tuple(rows[D + r * D + c] for c in range(D)) for r in range(D))
    return m, P


def _seed(x0_mean, x0_cov, D, zero):
    """(0, m0, P0) as components: the map that sets any state to x0."""
    zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))
    return (zmat, tuple(x0_mean.unbind(0)), tuple(tuple(row.unbind(0)) for row in x0_cov.unbind(0)))


def _chunk_lanes(x, chunks, fill):
    """(..., L, B) -> (..., Lc, chunks*B), Lc = ceil(L / chunks): chunk c of
    every block (its steps c*Lc .. c*Lc + Lc - 1) in lanes c*B .. c*B + B - 1,
    the steps past L filled with `fill`."""
    *lead, L, B = x.shape
    Lc = -(-L // chunks)
    x = torch.cat([x, x.new_full((*lead, chunks * Lc - L, B), fill)], dim=-2)
    return x.reshape(*lead, chunks, Lc, B).movedim(-3, -2).reshape(*lead, Lc, chunks * B)


def _chunk_step_exists(l, L, B, chunks, like):
    """None where step l of every chunk is one of the L steps, else the
    (chunks*B,) lanes whose chunk has a step l."""
    Lc = -(-L // chunks)
    if (chunks - 1) * Lc + l < L:
        return None
    starts = Lc * torch.arange(chunks, device=like.device)
    return (starts + l < L).repeat_interleave(B)


def _tree_map(fn, *trees):
    """fn over the leaves of nested tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *subtrees) for subtrees in zip(*trees))
    return fn(*trees)


def _fold_step(carry, new, exists):
    """`new`, or on the lanes whose chunk has no such step, `carry`."""
    if exists is None:
        return new
    return _tree_map(lambda n, c: torch.where(exists, n, c), new, carry)


def _unchunk(tree, chunks):
    """Components (..., chunks*B) -> one tree of (..., B) components a chunk."""
    return [_tree_map(lambda t: t.reshape(*t.shape[:-1], chunks, -1)[..., c, :], tree)
            for c in range(chunks)]


def _runs_to_steps(out, runs, L):
    """The states after each step of `runs` runs replayed side by side, a
    list of Lc (SD, runs*B) tensors -> (SD, L, B) in step order."""
    Lc = len(out)
    states = torch.stack(out, dim=1).reshape(out[0].shape[0], Lc, runs, -1)  # (SD, Lc, run, B)
    return states.transpose(1, 2).reshape(states.shape[0], runs * Lc, -1)[:, :L]


def _chunk_tree(aggs, combine):
    """The chunk aggregates combined in the kernels' order (K1, K4, K8): at span
    1, 2, 4, ..., aggregate w (w a multiple of 2 span) takes aggregate
    w + span on its right, so the earlier chunk is always on the left."""
    aggs = list(aggs)
    if len(aggs) & (len(aggs) - 1):
        raise ValueError(f"the chunk tree takes a power of two of chunks, got {len(aggs)}")
    span = 1
    while span < len(aggs):
        for w in range(0, len(aggs), 2 * span):
            aggs[w] = combine(aggs[w], aggs[w + span])
        span *= 2
    return aggs[0]


def _steps(y_blocked, s_blocked, packed, D, runs, trans_rows):
    """((y, s, A, a, Q) of every step of `runs` runs side by side as lanes,
    the emission (H, h)): the transition the packed constant, or with
    `trans_rows` (KT, L, B) each step's own row (the streamed kernels'
    input; a lane past its run's last step reads zeros, which its caller
    discards)."""
    A, a, Q, H, h = _unpack_params(packed, D)
    if trans_rows is not None:
        _check_trans_rows(trans_rows, D, y_blocked)
    ys = _chunk_lanes(y_blocked, runs, 0.0).unbind(0)
    ss = _chunk_lanes(s_blocked, runs, 1.0).unbind(0)
    if trans_rows is None:
        trans = itertools.repeat((A, a, Q))
    else:
        trans = (_affine_rows_to_tuple(r.unbind(0), D)
                 for r in _chunk_lanes(trans_rows, runs, 0.0).unbind(1))
    return [(y_l, s_l, *t) for y_l, s_l, t in zip(ys, ss, trans)], (H, h)


def _chunk_aggregates(y_blocked, s_blocked, packed, D, chunks, trans_rows=None):
    """The kernels' chunk folds (K1, K7): each block's L steps in `chunks`
    runs of ceil(L / chunks), each folded from the identity element (the runs
    side by side, as lanes) -> one element tree of (B,) components a run."""
    L, B = y_blocked.shape
    steps, (H, h) = _steps(y_blocked, s_blocked, packed, D, chunks, trans_rows)
    carry = _identity_elem((chunks * B,), D, y_blocked)
    for l, (y_l, s_l, A, a, Q) in enumerate(steps):
        new = lanes.combine(carry, lanes.step_element(A, a, Q, H, h, s_l, y_l, 1.0, 0.0))
        carry = _fold_step(carry, new, _chunk_step_exists(l, L, B, chunks, y_blocked))
    return _unchunk(carry, chunks)


def phase1_aggregate_plain(y_blocked, s_blocked, packed, D, chunks=None, trans_rows=None):
    """(L, B) streams -> ((K, B) block aggregates, (runs, K, B) run
    aggregates): for each block, the left fold of its L step elements from
    the identity element, and the folds of its runs.

    chunks=None folds each block's L steps in one run. With `chunks` (a
    power of two; K1's is PHASE1_AGGREGATE_CHUNKS) it takes K1's schedule:
    `_chunk_aggregates`, then the run aggregates combined by `_chunk_tree`.
    `trans_rows`, (KT, L, B) rows A, a, Q of every step, replaces the
    packed transition (K1's streamed form; serially, the reference's lane
    path `_phase1_aggregates_lanes`)."""
    aggs = _chunk_aggregates(y_blocked, s_blocked, packed, D, chunks or 1, trans_rows)
    rows = lambda e: torch.stack(_elem_tuple_to_rows(e))
    return rows(_chunk_tree(aggs, lanes.combine)), torch.stack([rows(run) for run in aggs])


def _shift(e, k, diag=1.0):
    """Shift every component of an element (filtering or affine: A first,
    then vectors and matrices) right by k blocks (the last axis), filling
    with the identity element, or with its tangent, all zeros, for diag=0."""
    def go(comp, fill):
        front = comp.new_full((*comp.shape[:-1], k), fill)
        return torch.cat([front, comp[..., : comp.shape[-1] - k]], dim=-1)

    def zeros(tree):
        return tuple(map(zeros, tree)) if isinstance(tree, tuple) else go(tree, 0.0)

    A, *rest = e
    D = len(A)
    A_s = tuple(tuple(go(A[r][c], diag if r == c else 0.0) for c in range(D)) for r in range(D))
    return (A_s, *map(zeros, rest))


def phase2_starts_plain(comps, x0_mean, x0_cov, D):
    """(K, B) aggregates -> (SD, B) block-start states,
    starts[b] = prior ∘ agg_0 ∘ ... ∘ agg_{b-1} with prior (0, m0, P0, 0, 0),
    by `_prefix_starts`."""
    zero = comps.new_zeros(())
    zmat, m0, P0 = _seed(x0_mean, x0_cov, D, zero)
    return _prefix_starts(_elem_rows_to_tuple(comps.unbind(0), D), lanes.combine,
                          (zmat, m0, P0, (zero,) * D, zmat))


def _prefix_starts(e, combine, seed):
    """(SD, B) block starts: the state that seed, then e_0, ..., e_{b-1}
    give for block b. The reference kernel's inclusive Kogge-Stone scan over
    the blocks (the last axis), earlier operand on the left at every level
    (combine is not commutative), shifted to exclusive and seeded."""
    B = e[1][0].shape[-1]
    k = 1
    while k < B:
        e = combine(_shift(e, k), e)
        k *= 2
    _, b, C, *_ = combine(seed, _shift(e, 1))
    return torch.stack(_state_tuple_to_rows(b, C))


def _run_starts(starts, D, aggs):
    """(m, P) of every run side by side, (runs*B,) components, from the
    (SD, B) block starts and the element trees of runs 0 .. runs-2: run c's
    start the state part of (0, m_b, P_b, 0, 0) ∘ agg_0 ∘ ... ∘ agg_{c-1},
    combined left to right (the seeding K2 does at block level)."""
    m, P = _state_rows_to_tuple(starts.unbind(0), D)
    run_starts = [(m, P)]
    zero = starts.new_zeros(starts.shape[1])
    zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))
    state = (zmat, m, P, (zero,) * D, zmat)
    for agg in aggs:
        state = lanes.combine(state, agg)
        run_starts.append((state[1], state[2]))
    return _tree_map(lambda *runs: torch.cat(runs), *run_starts)


def phase3_lml_plain(y_blocked, s_blocked, packed, starts, D, chunk_aggs=None,
                     trans_rows=None):
    """Per-block log marginal likelihood (B,): the Kalman recursion of each
    block from its start state.

    chunk_aggs=None runs each block's L steps in one run from its start.
    With `chunk_aggs`, the (runs, K, B) run aggregates that
    `phase1_aggregate_plain(..., chunks=runs)` gives, it takes K3's
    schedule: the steps split into runs of ceil(L / runs); run c's start by
    `_run_starts`; every run replayed from its start, side by side as lanes,
    a run past its last step adding nothing; and the runs' sums added in run
    order. `trans_rows` as in `phase1_aggregate_plain` (K3's streamed form;
    serially, the reference's `_phase3_lml_lanes`)."""
    L, B = y_blocked.shape
    n = 1 if chunk_aggs is None else chunk_aggs.shape[0]
    steps, (H, h) = _steps(y_blocked, s_blocked, packed, D, n, trans_rows)
    aggs = [] if chunk_aggs is None else chunk_aggs[:-1]
    m, P = _run_starts(starts, D, [_elem_rows_to_tuple(agg.unbind(0), D) for agg in aggs])
    acc = y_blocked.new_zeros(n * B)
    for l, (y_l, s_l, A, a, Q) in enumerate(steps):
        m, P, lml = lanes.kalman_step(m, P, A, a, Q, H, h, s_l, y_l)
        exists = _chunk_step_exists(l, L, B, n, y_blocked)
        acc = acc + (lml if exists is None else torch.where(exists, lml, 0.0))
    return functools.reduce(operator.add, acc.reshape(n, B).unbind(0))


# ---------------------------------------------------------------------------
# Plain forward-mode versions: the loops above under torch.func.jvp, so the
# tangents come from PyTorch's autodiff of ops/lanes.py, not from the
# formulas written out in csrc/lanes.cuh. Components are (k, B) tensors, one
# row per tangent direction: every direction repeats the primal (as the
# kernels' threads do) and one jvp call gives all k tangents.
# ---------------------------------------------------------------------------

def _unpack_rows(packed_rows, D, k):
    """(1+k, PK2) rows -> (primal params, tangent params, noise tangent), the
    params as `_unpack_params` tuples of (k, 1) components, the noise
    tangent (k, 1)."""
    primal = packed_rows[0].reshape(-1, 1, 1).repeat(1, k, 1)
    tangent = packed_rows[1:].T.reshape(-1, k, 1)
    return _unpack_params(primal, D), _unpack_params(tangent, D), tangent[-1]


def _stack_sets(primal_rows, tangent_rows):
    """Row lists of (k, B) components -> ((1+k)*R, B): the primal set (every
    direction holds the same one) followed by the k tangent sets."""
    primal = torch.stack(primal_rows)[:, 0]
    tangent = torch.stack(tangent_rows)
    R, k, B = tangent.shape
    return torch.cat([primal, tangent.permute(1, 0, 2).reshape(k * R, B)])


def _split_sets(stacked, R, k):
    """((1+k)*R, B) -> (primal rows, tangent rows), each R components (k, B)."""
    B = stacked.shape[1]
    primal = stacked[:R].unsqueeze(1).repeat(1, k, 1)
    tangent = stacked[R:].reshape(k, R, B).permute(1, 0, 2).contiguous()
    return primal.unbind(0), tangent.unbind(0)


def phase1_jvp_plain(y_blocked, s_blocked, packed_rows, D, k, chunks=None):
    """(L, B) streams and (1+k, PK2) rows -> (((1+k)*K, B), (runs, (1+k)*K,
    B)): the primal block aggregates followed by their k tangents, and the
    same sets of each run's aggregate. The noise tangent of a step is masked
    to zero where the streamed s marks it missing or padding.

    chunks=None folds each block's L steps in one run. With `chunks` (a
    power of two; K4's is PHASE1_JVP_CHUNKS) it takes K4's schedule: the steps
    split into `chunks` runs of ceil(L / chunks), each folded from the
    identity element (the runs side by side, as lanes), then the run
    aggregates combined by `_chunk_tree`."""
    L, B = y_blocked.shape
    C = chunks or 1
    primal, tangent, ds = _unpack_rows(packed_rows, D, k)
    slot = torch.zeros_like(ds)
    carry = _identity_elem((k, C * B), D, y_blocked)
    dcarry = _zero_elem((k, C * B), D, y_blocked)
    steps = zip(_chunk_lanes(y_blocked, C, 0.0).unbind(0),
                _chunk_lanes(s_blocked, C, 1.0).unbind(0))
    for l, (y_l, s_l) in enumerate(steps):
        mask = (s_l < _MASK_THRESH).to(s_l.dtype)
        exists = _chunk_step_exists(l, L, B, C, y_blocked)

        def fold(carry, A, a, Q, H, h, slot):
            step = lanes.step_element(A, a, Q, H, h, s_l + slot * mask, y_l, 1.0, 0.0)
            return _fold_step(carry, lanes.combine(carry, step), exists)

        carry, dcarry = torch.func.jvp(fold, (carry, *primal, slot), (dcarry, *tangent, ds))

    def combine_jvp(left, right):
        return torch.func.jvp(lanes.combine, (left[0], right[0]), (left[1], right[1]))

    def rows(pair):
        return _stack_sets(_elem_tuple_to_rows(pair[0]), _elem_tuple_to_rows(pair[1]))

    runs = list(zip(_unchunk(carry, C), _unchunk(dcarry, C)))
    return rows(_chunk_tree(runs, combine_jvp)), torch.stack([rows(run) for run in runs])


def phase2_jvp_starts_plain(comps, priors, D, k):
    """((1+k)*K, B) aggregates and (1+k, SD) priors -> ((1+k)*SD, B) block
    starts. The scan of `phase2_starts_plain` under jvp: a shifted tangent is
    filled with zeros (the identity element is a constant), and the prior
    element's tangent is (0, dm0, dP0, 0, 0)."""
    B = comps.shape[1]
    rows, drows = _split_sets(comps, elem_rows(D), k)
    e, de = _elem_rows_to_tuple(rows, D), _elem_rows_to_tuple(drows, D)
    n = 1
    while n < B:
        e, de = torch.func.jvp(lanes.combine, (_shift(e, n), e), (_shift(de, n, diag=0.0), de))
        n *= 2
    e, de = _shift(e, 1), _shift(de, 1, diag=0.0)
    zero = comps.new_zeros((k, 1))
    zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))

    def prior_elem(rows):
        m0, P0 = _state_rows_to_tuple(rows, D)
        return (zmat, m0, P0, (zero,) * D, zmat)

    prior = prior_elem(priors[0].reshape(-1, 1, 1).repeat(1, k, 1).unbind(0))
    dprior = prior_elem(priors[1:].T.reshape(-1, k, 1).unbind(0))
    (_, b, C, _, _), (_, db, dC, _, _) = torch.func.jvp(lanes.combine, (prior, e), (dprior, de))
    return _stack_sets(_state_tuple_to_rows(b, C), _state_tuple_to_rows(db, dC))


def phase3_jvp_lml_plain(y_blocked, s_blocked, packed_rows, starts, D, k, chunk_aggs=None):
    """-> (1+k, B): the per-block lml and its k tangents, the recursion of
    `phase3_lml_plain` under jvp from the primal and tangent start states.

    chunk_aggs=None runs each block's L steps in one run from its start.
    With `chunk_aggs`, the (runs, (1+k)*K, B) run aggregates that
    `phase1_jvp_plain(..., chunks=runs)` gives, it takes K6's schedule: the
    steps split into runs of ceil(L / runs); run c's start the state part of
    (0, m_b, P_b, 0, 0) ∘ agg_0 ∘ ... ∘ agg_{c-1} under jvp, combined left to
    right; every run replayed from its start, side by side as lanes; and the
    runs' sums added in run order."""
    L, B = y_blocked.shape
    n = 1 if chunk_aggs is None else chunk_aggs.shape[0]
    primal, tangent, ds = _unpack_rows(packed_rows, D, k)
    slot = torch.zeros_like(ds)
    rows, drows = _split_sets(starts, state_rows(D), k)
    (m, P), (dm, dP) = _state_rows_to_tuple(rows, D), _state_rows_to_tuple(drows, D)
    run_starts = [(m, P, dm, dP)]
    if n > 1:
        zero = starts.new_zeros((k, B))
        zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))
        state, dstate = (zmat, m, P, (zero,) * D, zmat), (zmat, dm, dP, (zero,) * D, zmat)
        for agg in chunk_aggs[:-1]:
            arows, darows = _split_sets(agg, elem_rows(D), k)
            state, dstate = torch.func.jvp(
                lanes.combine, (state, _elem_rows_to_tuple(arows, D)),
                (dstate, _elem_rows_to_tuple(darows, D)))
            run_starts.append((state[1], state[2], dstate[1], dstate[2]))
    m, P, dm, dP = _tree_map(lambda *runs: torch.cat(runs, dim=-1), *run_starts)
    acc, dacc = y_blocked.new_zeros((k, n * B)), y_blocked.new_zeros((k, n * B))
    for l, (y_l, s_l) in enumerate(zip(_chunk_lanes(y_blocked, n, 0.0).unbind(0),
                                       _chunk_lanes(s_blocked, n, 1.0).unbind(0))):
        mask = (s_l < _MASK_THRESH).to(s_l.dtype)

        def step(m, P, A, a, Q, H, h, slot):
            return lanes.kalman_step(m, P, A, a, Q, H, h, s_l + slot * mask, y_l)

        (m, P, lml), (dm, dP, dlml) = torch.func.jvp(
            step, (m, P, *primal, slot), (dm, dP, *tangent, ds))
        exists = _chunk_step_exists(l, L, B, n, y_blocked)
        if exists is not None:  # a run past its last step adds nothing
            lml, dlml = torch.where(exists, lml, 0.0), torch.where(exists, dlml, 0.0)
        acc, dacc = acc + lml, dacc + dlml
    acc, dacc = (functools.reduce(operator.add, x.reshape(k, n, B).unbind(1)) for x in (acc, dacc))
    return torch.cat([acc[:1], dacc])


# ---------------------------------------------------------------------------
# Plain state-emitting versions: smoothing and prediction
# ---------------------------------------------------------------------------

def phase3_states_plain(y_blocked, s_blocked, packed, starts, D, chunks=None,
                        trans_rows=None):
    """(L, B) streams and (SD, B) start states -> (SD, L, B): the Kalman
    recursion of each block from its start state, keeping the filtering
    state after every step.

    chunks=None runs each block's L steps in one run from its start. With
    `chunks` (K7's is PHASE3_STATES_CHUNKS) it takes K7's schedule: the steps
    split into `chunks` runs of ceil(L / chunks); the runs' aggregates by
    `_chunk_aggregates`; run c's start by `_run_starts`; and every run
    replayed from its start, side by side as lanes. `trans_rows` as in
    `phase1_aggregate_plain` (K7's streamed form)."""
    L, B = y_blocked.shape
    n = chunks or 1
    steps, (H, h) = _steps(y_blocked, s_blocked, packed, D, n, trans_rows)
    aggs = (_chunk_aggregates(y_blocked, s_blocked, packed, D, n, trans_rows)[:-1]
            if n > 1 else [])
    m, P = _run_starts(starts, D, aggs)
    out = []
    for y_l, s_l, A, a, Q in steps:
        m, P, _ = lanes.kalman_step(m, P, A, a, Q, H, h, s_l, y_l)
        out.append(torch.stack(_state_tuple_to_rows(m, P)))
    return _runs_to_steps(out, n, L)


def affine_phase1_plain(params, D, chunks=None):
    """(KT, L, B) affine maps -> ((KT, B) block aggregates, (runs, KT, B) run
    aggregates): for each block, the left fold of its L maps from the
    identity map (each step's map applied after the carry), and the folds of
    its runs.

    chunks=None folds each block's L maps in one run; with `chunks` (a power
    of two; K8's is AFFINE_PHASE1_CHUNKS) it takes K8's schedule, as
    `phase1_jvp_plain` takes K4's."""
    _, L, B = params.shape
    n = chunks or 1
    carry = _identity_elem((n * B,), D, params)[:3]
    for l, rows in enumerate(_chunk_lanes(params, n, 0.0).unbind(1)):
        new = lanes.affine_combine(carry, _affine_rows_to_tuple(rows.unbind(0), D))
        carry = _fold_step(carry, new, _chunk_step_exists(l, L, B, n, params))

    def rows(e):
        A, b, C = e
        return torch.stack([*_flat(A), *_state_tuple_to_rows(b, C)])

    runs = _unchunk(carry, n)
    return rows(_chunk_tree(runs, lanes.affine_combine)), torch.stack([rows(run) for run in runs])


def affine_phase2_starts_plain(agg, x0_mean, x0_cov, D):
    """(KT, B) aggregates -> (SD, B) block-start states,
    starts[b] = x0 then agg_0, ..., agg_{b-1}, with x0 the map (0, m0, P0),
    by `_prefix_starts`."""
    return _prefix_starts(_affine_rows_to_tuple(agg.unbind(0), D), lanes.affine_combine,
                          _seed(x0_mean, x0_cov, D, agg.new_zeros(())))


def affine_phase3_states_plain(params, starts, D, chunk_aggs=None):
    """(KT, L, B) affine maps and (SD, B) start states -> (SD, L, B): the
    affine recursion of each block from its start, keeping the state after
    every step.

    chunk_aggs=None runs each block's L steps in one run from its start.
    With `chunk_aggs`, the (runs, KT, B) run aggregates that
    `affine_phase1_plain(..., chunks=runs)` gives, it takes K10's schedule:
    run c starts from the block start pushed through the maps of runs 0 ..
    c-1 in order, and the runs are replayed side by side as lanes."""
    L = params.shape[1]
    n = 1 if chunk_aggs is None else chunk_aggs.shape[0]
    m, P = _state_rows_to_tuple(starts.unbind(0), D)
    run_starts = [(m, P)]
    for agg in () if chunk_aggs is None else chunk_aggs[:-1]:
        m, P = lanes.affine_step(m, P, *_affine_rows_to_tuple(agg.unbind(0), D))
        run_starts.append((m, P))
    m, P = _tree_map(lambda *runs: torch.cat(runs), *run_starts)
    out = []
    for rows in _chunk_lanes(params, n, 0.0).unbind(1):
        m, P = lanes.affine_step(m, P, *_affine_rows_to_tuple(rows.unbind(0), D))
        out.append(torch.stack(_state_tuple_to_rows(m, P)))
    return _runs_to_steps(out, n, L)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

# K1. Replaces temporalgps_tpu/ops/pallas_kernels.py phase1_aggregate
# (_phase1_kernel). Folds each block's L step elements, reading y[l, b] and
# s[l, b] (a warp reads 32 neighbouring addresses). Bound by operations (738
# dependent flops a step at D = 3 against 2 values read), and on this card
# by how many warps issue them: one thread a block was 64 warps at B = 2048
# for 528 schedulers. So K1 takes K4's schedule without the tangent: each
# group of 32 blocks has PHASE1_AGGREGATE_CHUNKS warps, warp w folding the
# w-th run of ceil(L / C) steps, and the run aggregates are combined in order
# in shared memory, then across the cluster of thread blocks that holds the
# C warps (`phase1_aggregate_plain(..., chunks=C)` is the same schedule).
# Before the tree each warp stores its run aggregate, which K3 reads.
def phase1_aggregate(y_blocked, s_blocked, packed, D):
    """(L, B) y and noise streams -> ((K, B) block aggregate elements,
    (PHASE1_AGGREGATE_CHUNKS, K, B) run aggregates; one run on the CPU,
    where the serial plain version runs)."""
    if _route(y_blocked, s_blocked, packed) == "cpu":
        return phase1_aggregate_plain(y_blocked, s_blocked, packed, D)
    out = _launch_phase1(y_blocked, s_blocked, packed, None, D)
    phase1_aggregate.launches += 1
    return out


phase1_aggregate.launches = 0


def _check_trans_rows(trans_rows, D, y_blocked):
    _check_shape("trans_rows", trans_rows, (affine_rows(D), *y_blocked.shape))


def _launch_phase1(y_blocked, s_blocked, packed, trans_rows, D):
    """K1 on the packed constants (trans_rows None) or on per-step rows."""
    _check_kernel_args(D, y_blocked, s_blocked, packed,
                       *(() if trans_rows is None else (trans_rows,)))
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    out = torch.empty((elem_rows(D), B), dtype=y_blocked.dtype, device=y_blocked.device)
    chunk_out = out.new_empty((PHASE1_AGGREGATE_CHUNKS, *out.shape))
    _launch("phase1_aggregate", (y_blocked, s_blocked, packed, trans_rows, out, chunk_out),
            (L, B, D, PHASE1_AGGREGATE_CHUNKS))
    return out, chunk_out


# K1's streamed form. K1 reading each step's (A, a, Q) from (KT, L, B) rows
# (row r of step l of block b at r*L*B + l*B + b, so a warp reads 32
# neighbouring addresses a row), with H and h from the packed row, whose
# transition slots it does not read: the models of irregular times. The
# same schedule, grid and cluster as K1 (csrc/lanes.cuh `StreamedTrans`,
# the next step's row loaded before the current step is folded). Bound by
# bytes on paper: KT + 2 values read a step against K1's 738 flops at
# D = 3 (`phase1_aggregate_plain(..., chunks=C, trans_rows=...)` is the same
# schedule).
def phase1_aggregate_streamed(y_blocked, s_blocked, packed, D, trans_rows):
    """(L, B) streams, the (PK,) emission row and (KT, L, B) transition rows
    -> K1's pair, ((K, B), (PHASE1_AGGREGATE_CHUNKS, K, B)); one run on the
    CPU, where the serial plain version runs."""
    if _route(y_blocked, s_blocked, packed, trans_rows) == "cpu":
        return phase1_aggregate_plain(y_blocked, s_blocked, packed, D, trans_rows=trans_rows)
    _check_trans_rows(trans_rows, D, y_blocked)
    out = _launch_phase1(y_blocked, s_blocked, packed, trans_rows, D)
    phase1_aggregate_streamed.launches += 1
    return out


phase1_aggregate_streamed.launches = 0


# K2. Replaces temporalgps_tpu/ops/pallas_kernels.py phase2_starts
# (_phase2_kernel). The TPU kernel scans all (K, B) aggregates in VMEM (540
# KB at B = 2048 in float64, above the 227 KB of shared memory a thread
# block may have). Bound on paper by bytes (0.1 us), in practice by the
# depth of its chain of dependent combines. So it runs the cluster scan of
# csrc/scan.cuh, which K5 and K9 share: each lane of one cluster of 8
# thread blocks of 8 warps holds one aggregate (a warp reads 32
# neighbouring addresses a row) and the scan is a Kogge-Stone across the
# warp's lanes in shuffles, then across the warp totals in shared memory,
# then across the thread-block totals in the cluster's: at B = 2048, 5 + 3
# + 3 dependent combines and 3 state-only ones to finish, on 8 SMs. A
# larger B is scanned in rounds of 2048 in order, each seeded with the
# state the earlier rounds end in; any B >= 1 is taken.
def phase2_starts(comps, x0_mean, x0_cov, D):
    """(K, B) block aggregates and the prior (m0, P0) -> (SD, B) block-start
    filtering states (mean rows, then row-major covariance rows)."""
    if _route(comps, x0_mean, x0_cov) == "cpu":
        return phase2_starts_plain(comps, x0_mean, x0_cov, D)
    prior = _prior_row(x0_mean, x0_cov, comps.dtype)
    _check_kernel_args(D, comps, prior)
    if comps.ndim != 2 or comps.shape[0] != elem_rows(D):
        raise ValueError(f"comps must be ({elem_rows(D)}, B), got {tuple(comps.shape)}")
    _check_shape("prior", prior, (state_rows(D),))
    B = comps.shape[1]
    out = torch.empty((state_rows(D), B), dtype=comps.dtype, device=comps.device)
    _launch("phase2_starts", (comps, prior, out), (B, D))
    phase2_starts.launches += 1
    return out


phase2_starts.launches = 0


# K3. Replaces temporalgps_tpu/ops/pallas_kernels.py phase3_lml
# (_phase3_kernel). Runs the predict + scalar-update recursion of each block
# from its start state and writes its summed log marginal likelihood; the
# sum over blocks and the padding compensation stay outside (ops/block.py).
# Bound by operations (215 flops a step at D = 3); one thread a block left it
# bound by the latency of the L-step recursion on 64 warps. So it takes K1's
# grid and cluster: warp c of 32 blocks starts run c from the block start
# pushed through K1's run aggregates 0 .. c-1 (the state part of each
# combine only), replays the run's ceil(L / C) steps, and the C run sums are
# added in run order across the cluster
# (`phase3_lml_plain(..., chunk_aggs=...)` is the same schedule).
def phase3_lml(y_blocked, s_blocked, packed, starts, D, chunk_aggs):
    """(L, B) streams, (SD, B) start states and the run aggregates of
    `phase1_aggregate` -> (B,) per-block lml."""
    if _route(y_blocked, s_blocked, packed, starts, chunk_aggs) == "cpu":
        return phase3_lml_plain(y_blocked, s_blocked, packed, starts, D, chunk_aggs)
    out = _launch_phase3(y_blocked, s_blocked, packed, None, starts, D, chunk_aggs)
    phase3_lml.launches += 1
    return out


phase3_lml.launches = 0


def _launch_phase3(y_blocked, s_blocked, packed, trans_rows, starts, D, chunk_aggs):
    """K3 on the packed constants (trans_rows None) or on per-step rows."""
    _check_kernel_args(D, y_blocked, s_blocked, packed, starts, chunk_aggs,
                       *(() if trans_rows is None else (trans_rows,)))
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    _check_shape("starts", starts, (state_rows(D), B))
    _check_shape("chunk_aggs", chunk_aggs, (PHASE1_AGGREGATE_CHUNKS, elem_rows(D), B))
    out = torch.empty((B,), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_lml", (y_blocked, s_blocked, packed, trans_rows, starts, chunk_aggs, out),
            (L, B, D, PHASE1_AGGREGATE_CHUNKS))
    return out


# K3's streamed form: K3's replay of K1's runs with each step's (A, a, Q)
# read from the rows as K1's streamed form reads them (the run's first row
# loaded after its start chain, each next one before the current step).
# KT + 2 values read a step against 215 flops at D = 3: bound by bytes
# (`phase3_lml_plain(..., chunk_aggs=..., trans_rows=...)` is the same
# schedule).
def phase3_lml_streamed(y_blocked, s_blocked, packed, starts, D, chunk_aggs, trans_rows):
    """(L, B) streams, the emission row, (SD, B) start states, the run
    aggregates of `phase1_aggregate_streamed` and the (KT, L, B) transition
    rows -> (B,) per-block lml."""
    if _route(y_blocked, s_blocked, packed, starts, chunk_aggs, trans_rows) == "cpu":
        return phase3_lml_plain(y_blocked, s_blocked, packed, starts, D, chunk_aggs,
                                trans_rows=trans_rows)
    _check_trans_rows(trans_rows, D, y_blocked)
    out = _launch_phase3(y_blocked, s_blocked, packed, trans_rows, starts, D, chunk_aggs)
    phase3_lml_streamed.launches += 1
    return out


phase3_lml_streamed.launches = 0


def _check_tangent_count(k):
    if k < 1:
        raise ValueError(f"the forward-mode kernels take k >= 1 tangents, got {k}")


def _check_jvp_rows(packed_rows, D, k):
    _check_tangent_count(k)
    _check_shape("packed parameter rows", packed_rows, (1 + k, param_s_len(D)))


# K4. Replaces temporalgps_tpu/ops/pallas_kernels.py phase1_jvp
# (_phase1_jvp_kernel). K1 carrying a tangent element beside the primal; the
# reference linearises each step in-kernel, here the tangents of step_element
# and combine are written out (csrc/lanes.cuh). Threads (b, j) of a
# (ceil(B/32), k) grid carry block b's primal and tangent j; the primal is
# recomputed k times rather than held with k tangents in one thread, which
# registers forbid and a runtime k cannot unroll. Bound by operations (at
# D = 3, 738 flops a step for the primal and 1522 for each tangent, against
# 2 values read), and on this card by how many warps issue them: one warp a
# (32 blocks, tangent) pair would be 192 warps for 528 schedulers. So a
# (32 blocks, tangent) pair has PHASE1_JVP_CHUNKS warps, warp w folding the
# w-th run of ceil(L / C) steps of the same 32 blocks, as a cluster of two
# thread blocks of 8 warps (a thread needs 255 registers), and the run
# aggregates are combined in order in shared memory, then across the
# cluster (`phase1_jvp_plain(..., chunks=C)` is the same schedule). Before
# the tree each warp stores its run aggregate, which K6 reads.
def phase1_jvp(y_blocked, s_blocked, packed_rows, D, k):
    """(L, B) streams and (1+k, PK2) parameter rows -> (((1+k)*K, B),
    (PHASE1_JVP_CHUNKS, (1+k)*K, B)): the primal block aggregates followed by
    the k tangent sets, and the same sets of each run's aggregate (one run
    on the CPU, where the serial plain version runs)."""
    _check_kernel_args(D, y_blocked, s_blocked, packed_rows)
    _check_streams(y_blocked, s_blocked)
    _check_jvp_rows(packed_rows, D, k)
    if _route(y_blocked, s_blocked, packed_rows) == "cpu":
        return phase1_jvp_plain(y_blocked, s_blocked, packed_rows, D, k)
    L, B = y_blocked.shape
    out = torch.empty(((1 + k) * elem_rows(D), B), dtype=y_blocked.dtype,
                      device=y_blocked.device)
    chunk_out = out.new_empty((PHASE1_JVP_CHUNKS, *out.shape))
    _launch("phase1_jvp", (y_blocked, s_blocked, packed_rows, out, chunk_out),
            (L, B, D, k, PHASE1_JVP_CHUNKS))
    phase1_jvp.launches += 1
    return out, chunk_out


phase1_jvp.launches = 0


# K5. Replaces temporalgps_tpu/ops/pallas_kernels.py phase2_jvp_starts
# (_phase2_jvp_kernel). The reference scans all 1+k element sets in one
# program in VMEM. Bound on paper by bytes ((1+k)(K + SD) B values moved),
# in practice by the depth of its chain of dependent combines. So it is K2's
# cluster scan (csrc/scan.cuh) on (primal, tangent j) pairs: one cluster of
# 8 thread blocks of 8 warps per tangent (the primal recomputed in each,
# written by the first), one pair a lane, a Kogge-Stone across each warp's
# lanes, then across the warp and thread-block totals: at B = 2048, 5 + 3
# + 3 dependent combine_jvps and 3 state-only ones; a larger B in rounds of
# 2048. A pair is 66 values, two of them 264 registers in float64, so in
# float64 each level reads its left pair from shared memory (dynamic, 132 KB
# a thread block at D = 3) rather than shuffles. Any B >= 1 and
# 1 <= k <= 65535 are taken.
def phase2_jvp_starts(comps, priors, D, k):
    """((1+k)*K, B) aggregates and (1+k, SD) priors (m0 then row-major P0, for
    the primal and each tangent) -> ((1+k)*SD, B) block-start states."""
    _check_kernel_args(D, comps, priors)
    _check_tangent_count(k)
    if comps.ndim != 2 or comps.shape[0] != (1 + k) * elem_rows(D):
        raise ValueError(
            f"comps must be ({(1 + k) * elem_rows(D)}, B), got {tuple(comps.shape)}")
    _check_shape("priors", priors, (1 + k, state_rows(D)))
    if _route(comps, priors) == "cpu":
        return phase2_jvp_starts_plain(comps, priors, D, k)
    B = comps.shape[1]
    out = torch.empty(((1 + k) * state_rows(D), B), dtype=comps.dtype, device=comps.device)
    _launch("phase2_jvp_starts", (comps, priors, out), (B, D, k))
    phase2_jvp_starts.launches += 1
    return out


phase2_jvp_starts.launches = 0


# K6. Replaces temporalgps_tpu/ops/pallas_kernels.py phase3_jvp_lml
# (_phase3_jvp_kernel). K3 carrying a tangent state and a tangent lml sum;
# thread (b, j) as in K4. Bound by operations (at D = 3, 215 flops a step
# for the primal and 406 for each tangent); one thread a (block, tangent)
# left it bound by the latency of the L-step recursion. So it takes K4's
# grid and cluster: warp c of a (32 blocks, tangent) pair starts run c from
# the block start pushed through K4's run aggregates 0 .. c-1 (the state
# part of each combine only), replays the run's ceil(L / C) steps, and the
# C run sums are added in run order across the cluster
# (`phase3_jvp_lml_plain(..., chunk_aggs=...)` is the same schedule). It is
# then bound by instruction issue: a replay step is some 480 instructions,
# and an SM holds one 8-warp thread block at its register count.
def phase3_jvp_lml(y_blocked, s_blocked, packed_rows, starts, D, k, chunk_aggs):
    """(L, B) streams, (1+k, PK2) rows, ((1+k)*SD, B) starts and the run
    aggregates of `phase1_jvp` -> (1+k, B): the per-block lml followed by its
    k tangents."""
    _check_kernel_args(D, y_blocked, s_blocked, packed_rows, starts, chunk_aggs)
    _check_streams(y_blocked, s_blocked)
    _check_jvp_rows(packed_rows, D, k)
    L, B = y_blocked.shape
    _check_shape("starts", starts, ((1 + k) * state_rows(D), B))
    if _route(y_blocked, s_blocked, packed_rows, starts, chunk_aggs) == "cpu":
        return phase3_jvp_lml_plain(y_blocked, s_blocked, packed_rows, starts, D, k, chunk_aggs)
    _check_shape("chunk_aggs", chunk_aggs, (PHASE1_JVP_CHUNKS, (1 + k) * elem_rows(D), B))
    out = torch.empty((1 + k, B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_jvp_lml", (y_blocked, s_blocked, packed_rows, starts, chunk_aggs, out),
            (L, B, D, k, PHASE1_JVP_CHUNKS))
    phase3_jvp_lml.launches += 1
    return out


phase3_jvp_lml.launches = 0


def _check_affine_params(params, D):
    if params.ndim != 3 or params.shape[0] != affine_rows(D):
        raise ValueError(f"params must be ({affine_rows(D)}, L, B), got {tuple(params.shape)}")


# K7. Replaces temporalgps_tpu/ops/pallas_kernels.py phase3_states
# (_phase3_states_kernel). Runs the predict + scalar-update recursion of each
# block from its start state and writes the state after every step to
# out[r, l, b], so a warp stores 32 neighbouring addresses per row. Bound by
# bytes on paper (SD values written a step, 209 flops at D = 3); one thread
# a block left it bound by the latency of the L-step recursion. So each
# block's steps are split into PHASE3_STATES_CHUNKS runs, one warp each, and
# in one launch every warp folds its run (as K1 does), forms its run's start
# from the block start and the earlier runs' aggregates (shared through
# shared memory across the cluster that holds the C warps), and replays its
# run from there (`phase3_states_plain(..., chunks=C)` is the same schedule).
def phase3_states(y_blocked, s_blocked, packed, starts, D):
    """(L, B) streams and (SD, B) start states -> (SD, L, B) filtering
    states after every step."""
    if _route(y_blocked, s_blocked, packed, starts) == "cpu":
        return phase3_states_plain(y_blocked, s_blocked, packed, starts, D)
    out = _launch_phase3_states(y_blocked, s_blocked, packed, None, starts, D)
    phase3_states.launches += 1
    return out


phase3_states.launches = 0


def _launch_phase3_states(y_blocked, s_blocked, packed, trans_rows, starts, D):
    """K7 on the packed constants (trans_rows None) or on per-step rows."""
    _check_kernel_args(D, y_blocked, s_blocked, packed, starts,
                       *(() if trans_rows is None else (trans_rows,)))
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    _check_shape("starts", starts, (state_rows(D), B))
    out = torch.empty((state_rows(D), L, B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_states", (y_blocked, s_blocked, packed, trans_rows, starts, out),
            (L, B, D, PHASE3_STATES_CHUNKS))
    return out


# K7's streamed form: K7's fold and replay of each chunk with each step's
# (A, a, Q) read from the rows (twice a step: once to fold, once to replay).
# 2 KT + 2 values read and SD written a step against 209 + 738 flops at
# D = 3: bound by bytes (`phase3_states_plain(..., chunks=C,
# trans_rows=...)` is the same schedule).
def phase3_states_streamed(y_blocked, s_blocked, packed, starts, D, trans_rows):
    """(L, B) streams, the emission row, (SD, B) start states and the
    (KT, L, B) transition rows -> (SD, L, B) filtering states after every
    step."""
    if _route(y_blocked, s_blocked, packed, starts, trans_rows) == "cpu":
        return phase3_states_plain(y_blocked, s_blocked, packed, starts, D,
                                   trans_rows=trans_rows)
    _check_trans_rows(trans_rows, D, y_blocked)
    out = _launch_phase3_states(y_blocked, s_blocked, packed, trans_rows, starts, D)
    phase3_states_streamed.launches += 1
    return out


phase3_states_streamed.launches = 0


# K8. Replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase1
# (_affine_phase1_kernel). Folds each block's L time-varying maps, reading
# KT rows a step (a warp reads 32 neighbouring addresses per row). Bound by
# bytes (KT values a step against ~2 D^3 flops); one thread per block kept
# one step of KT rows a thread in flight, about 170 KB at B = 2048 where the
# memory needs megabytes to stay busy. So each thread block
# is AFFINE_PHASE1_CHUNKS warps, warp w folding the w-th run of
# ceil(L / C) steps of the same 32 blocks with the next steps' loads issued
# before each composition, and the run aggregates are combined in order in
# shared memory (`affine_phase1_plain(..., chunks=C)` is the same schedule).
# Before the tree each warp stores its run aggregate, which K10 reads.
def affine_phase1(params, D):
    """(KT, L, B) affine maps -> ((KT, B) block aggregates,
    (AFFINE_PHASE1_CHUNKS, KT, B) run aggregates; one run on the CPU, where
    the serial plain version runs)."""
    if _route(params) == "cpu":
        return affine_phase1_plain(params, D)
    _check_kernel_args(D, params)
    _check_affine_params(params, D)
    _, L, B = params.shape
    out = torch.empty((affine_rows(D), B), dtype=params.dtype, device=params.device)
    chunk_out = out.new_empty((AFFINE_PHASE1_CHUNKS, *out.shape))
    _launch("affine_phase1", (params, out, chunk_out), (L, B, D, AFFINE_PHASE1_CHUNKS))
    affine_phase1.launches += 1
    return out, chunk_out


affine_phase1.launches = 0


# K9. Replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase2_starts
# (_affine_phase2_kernel). The TPU kernel holds all (KT, B) aggregates in
# VMEM (344 KB at B = 2048 in float64, above the 227 KB of shared memory a
# thread block may have). Bound on paper by bytes, in practice by the depth
# of its chain of dependent compositions. So it is K2's cluster scan
# (csrc/scan.cuh) on affine maps: one aggregate a lane of one cluster of 8
# thread blocks of 8 warps, a Kogge-Stone across each warp's lanes in
# shuffles (21 values a map at D = 3), then across the warp and
# thread-block totals: at B = 2048, 5 + 3 + 3 dependent affine_combines and
# 3 affine_steps, seeded with x0; a larger B in rounds of 2048.
def affine_phase2_starts(agg, x0_mean, x0_cov, D):
    """(KT, B) aggregates and the initial state (m0, P0) -> (SD, B)
    block-start states."""
    if _route(agg, x0_mean, x0_cov) == "cpu":
        return affine_phase2_starts_plain(agg, x0_mean, x0_cov, D)
    prior = _prior_row(x0_mean, x0_cov, agg.dtype)
    _check_kernel_args(D, agg, prior)
    if agg.ndim != 2 or agg.shape[0] != affine_rows(D):
        raise ValueError(f"agg must be ({affine_rows(D)}, B), got {tuple(agg.shape)}")
    _check_shape("prior", prior, (state_rows(D),))
    B = agg.shape[1]
    out = torch.empty((state_rows(D), B), dtype=agg.dtype, device=agg.device)
    _launch("affine_phase2_starts", (agg, prior, out), (B, D))
    affine_phase2_starts.launches += 1
    return out


affine_phase2_starts.launches = 0


# K10. Replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase3_states
# (_affine_phase3_kernel). Replays m <- A m + b, P <- sym(A P A^T) + C over
# each block's steps, reading KT rows and writing SD rows a step, each row a
# coalesced warp access. Bound by bytes ((KT + SD) values a step); one
# thread a block waited one trip to memory a step. So each block's steps
# are K8's AFFINE_PHASE1_CHUNKS runs, one warp each: warp c starts from the
# block start pushed through K8's run aggregates 0 .. c-1 and replays its
# run with the next step's rows loaded ahead
# (`affine_phase3_states_plain(..., chunk_aggs=...)` is the same schedule).
def affine_phase3_states(params, starts, D, chunk_aggs):
    """(KT, L, B) affine maps, (SD, B) start states and the run aggregates of
    `affine_phase1` -> (SD, L, B) states after every step."""
    if _route(params, starts, chunk_aggs) == "cpu":
        return affine_phase3_states_plain(params, starts, D, chunk_aggs)
    _check_kernel_args(D, params, starts, chunk_aggs)
    _check_affine_params(params, D)
    _, L, B = params.shape
    _check_shape("starts", starts, (state_rows(D), B))
    _check_shape("chunk_aggs", chunk_aggs, (AFFINE_PHASE1_CHUNKS, affine_rows(D), B))
    out = torch.empty((state_rows(D), L, B), dtype=params.dtype, device=params.device)
    _launch("affine_phase3_states", (params, starts, chunk_aggs, out),
            (L, B, D, AFFINE_PHASE1_CHUNKS))
    affine_phase3_states.launches += 1
    return out


affine_phase3_states.launches = 0

WRAPPERS = (phase1_aggregate, phase2_starts, phase3_lml,
            phase1_jvp, phase2_jvp_starts, phase3_jvp_lml,
            phase3_states, affine_phase1, affine_phase2_starts, affine_phase3_states,
            phase1_aggregate_streamed, phase3_lml_streamed, phase3_states_streamed)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
