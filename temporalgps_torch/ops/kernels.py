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
# kPhase3StatesChunks and kAffineChunks. Each launch passes its constant and
# the kernel refuses any other, so the plain versions' chunks= and the card's
# schedule are the same.
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
    "phase1_aggregate": (4, 4),  # y, s, params, out; L, B, D, chunks
    "phase2_starts": (3, 2),     # comps, prior, starts; B, D
    "phase3_lml": (5, 3),        # y, s, params, starts, lml; L, B, D
    "phase1_jvp": (4, 5),         # y, s, rows, out; L, B, D, k, chunks
    "phase2_jvp_starts": (3, 3),  # comps, priors, starts; B, D, k
    "phase3_jvp_lml": (5, 4),     # y, s, rows, starts, lml; L, B, D, k
    "phase3_states": (5, 4),         # y, s, params, starts, out; L, B, D, chunks
    "affine_phase1": (2, 4),         # params, out; L, B, D, chunks
    "affine_phase2_starts": (3, 2),  # agg, prior, starts; B, D
    "affine_phase3_states": (3, 3),  # params, starts, out; L, B, D
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
    """Call the C entry `name` for the tensors' dtype on the current stream;
    raise if the launch reports an error."""
    lib = _library()
    fn = getattr(lib, f"tgps_{name}_{_DTYPE_SUFFIX[tensors[0].dtype]}")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
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


def _chunk_aggregates(y_blocked, s_blocked, packed, D, chunks):
    """The kernels' chunk folds (K1, K7): each block's L steps in `chunks`
    runs of ceil(L / chunks), each folded from the identity element (the runs
    side by side, as lanes) -> one element tree of (B,) components a run."""
    L, B = y_blocked.shape
    A, a, Q, H, h = _unpack_params(packed, D)
    carry = _identity_elem((chunks * B,), D, y_blocked)
    steps = zip(_chunk_lanes(y_blocked, chunks, 0.0).unbind(0),
                _chunk_lanes(s_blocked, chunks, 1.0).unbind(0))
    for l, (y_l, s_l) in enumerate(steps):
        new = lanes.combine(carry, lanes.step_element(A, a, Q, H, h, s_l, y_l, 1.0, 0.0))
        carry = _fold_step(carry, new, _chunk_step_exists(l, L, B, chunks, y_blocked))
    return _unchunk(carry, chunks)


def phase1_aggregate_plain(y_blocked, s_blocked, packed, D, chunks=None):
    """(L, B) streams -> (K, B) block aggregates: for each block, the left
    fold of its L step elements from the identity element.

    chunks=None folds each block's L steps in one run. With `chunks` (a
    power of two; K1's is PHASE1_AGGREGATE_CHUNKS) it takes K1's schedule:
    `_chunk_aggregates`, then the run aggregates combined by `_chunk_tree`."""
    aggs = _chunk_aggregates(y_blocked, s_blocked, packed, D, chunks or 1)
    return torch.stack(_elem_tuple_to_rows(_chunk_tree(aggs, lanes.combine)))


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


def phase3_lml_plain(y_blocked, s_blocked, packed, starts, D):
    """Per-block log marginal likelihood (B,): the Kalman recursion of each
    block from its start state."""
    L, B = y_blocked.shape
    A, a, Q, H, h = _unpack_params(packed, D)
    m, P = _state_rows_to_tuple(starts.unbind(0), D)
    acc = y_blocked.new_zeros(B)
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        m, P, lml = lanes.kalman_step(m, P, A, a, Q, H, h, s_l, y_l)
        acc = acc + lml
    return acc


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
    """(L, B) streams and (1+k, PK2) rows -> ((1+k)*K, B): the primal block
    aggregates followed by their k tangents. The noise tangent of a step is
    masked to zero where the streamed s marks it missing or padding.

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

    carry, dcarry = _chunk_tree(zip(_unchunk(carry, C), _unchunk(dcarry, C)), combine_jvp)
    return _stack_sets(_elem_tuple_to_rows(carry), _elem_tuple_to_rows(dcarry))


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


def phase3_jvp_lml_plain(y_blocked, s_blocked, packed_rows, starts, D, k):
    """-> (1+k, B): the per-block lml and its k tangents, the recursion of
    `phase3_lml_plain` under jvp from the primal and tangent start states."""
    L, B = y_blocked.shape
    primal, tangent, ds = _unpack_rows(packed_rows, D, k)
    slot = torch.zeros_like(ds)
    rows, drows = _split_sets(starts, state_rows(D), k)
    (m, P), (dm, dP) = _state_rows_to_tuple(rows, D), _state_rows_to_tuple(drows, D)
    acc, dacc = y_blocked.new_zeros((k, B)), y_blocked.new_zeros((k, B))
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        mask = (s_l < _MASK_THRESH).to(s_l.dtype)

        def step(m, P, A, a, Q, H, h, slot):
            return lanes.kalman_step(m, P, A, a, Q, H, h, s_l + slot * mask, y_l)

        (m, P, lml), (dm, dP, dlml) = torch.func.jvp(
            step, (m, P, *primal, slot), (dm, dP, *tangent, ds))
        acc, dacc = acc + lml, dacc + dlml
    return torch.cat([acc[:1], dacc])


# ---------------------------------------------------------------------------
# Plain state-emitting versions: smoothing and prediction
# ---------------------------------------------------------------------------

def phase3_states_plain(y_blocked, s_blocked, packed, starts, D, chunks=None):
    """(L, B) streams and (SD, B) start states -> (SD, L, B): the Kalman
    recursion of each block from its start state, keeping the filtering
    state after every step.

    chunks=None runs each block's L steps in one run from its start. With
    `chunks` (K7's is PHASE3_STATES_CHUNKS) it takes K7's schedule: the steps
    split into `chunks` runs of ceil(L / chunks); the runs' aggregates by
    `_chunk_aggregates`; run c's start the state part of
    (0, m_b, P_b, 0, 0) ∘ agg_0 ∘ ... ∘ agg_{c-1}, combined left to right;
    and every run replayed from its start, side by side as lanes."""
    L, B = y_blocked.shape
    n = chunks or 1
    A, a, Q, H, h = _unpack_params(packed, D)
    m, P = _state_rows_to_tuple(starts.unbind(0), D)
    run_starts = [(m, P)]
    if n > 1:
        zero = starts.new_zeros(B)
        zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))
        state = (zmat, m, P, (zero,) * D, zmat)
        for agg in _chunk_aggregates(y_blocked, s_blocked, packed, D, n)[:-1]:
            state = lanes.combine(state, agg)
            run_starts.append((state[1], state[2]))
    m, P = _tree_map(lambda *runs: torch.cat(runs), *run_starts)
    out = []
    for y_l, s_l in zip(_chunk_lanes(y_blocked, n, 0.0).unbind(0),
                        _chunk_lanes(s_blocked, n, 1.0).unbind(0)):
        m, P, _ = lanes.kalman_step(m, P, A, a, Q, H, h, s_l, y_l)
        out.append(torch.stack(_state_tuple_to_rows(m, P)))
    Lc = len(out)
    runs = torch.stack(out, dim=1).reshape(-1, Lc, n, B)  # (SD, Lc, run, B)
    return runs.transpose(1, 2).reshape(-1, n * Lc, B)[:, :L]


def affine_phase1_plain(params, D, chunks=None):
    """(KT, L, B) affine maps -> (KT, B) block aggregates: for each block,
    the left fold of its L maps from the identity map (each step's map
    applied after the carry).

    chunks=None folds each block's L maps in one run; with `chunks` (a power
    of two; K8's is AFFINE_PHASE1_CHUNKS) it takes K8's schedule, as
    `phase1_jvp_plain` takes K4's."""
    _, L, B = params.shape
    n = chunks or 1
    carry = _identity_elem((n * B,), D, params)[:3]
    for l, rows in enumerate(_chunk_lanes(params, n, 0.0).unbind(1)):
        new = lanes.affine_combine(carry, _affine_rows_to_tuple(rows.unbind(0), D))
        carry = _fold_step(carry, new, _chunk_step_exists(l, L, B, n, params))
    A, b, C = _chunk_tree(_unchunk(carry, n), lanes.affine_combine)
    return torch.stack([*_flat(A), *_state_tuple_to_rows(b, C)])


def affine_phase2_starts_plain(agg, x0_mean, x0_cov, D):
    """(KT, B) aggregates -> (SD, B) block-start states,
    starts[b] = x0 then agg_0, ..., agg_{b-1}, with x0 the map (0, m0, P0),
    by `_prefix_starts`."""
    return _prefix_starts(_affine_rows_to_tuple(agg.unbind(0), D), lanes.affine_combine,
                          _seed(x0_mean, x0_cov, D, agg.new_zeros(())))


def affine_phase3_states_plain(params, starts, D):
    """(KT, L, B) affine maps and (SD, B) start states -> (SD, L, B): the
    affine recursion of each block from its start, keeping the state after
    every step."""
    m, P = _state_rows_to_tuple(starts.unbind(0), D)
    out = []
    for rows in params.unbind(1):
        m, P = lanes.affine_step(m, P, *_affine_rows_to_tuple(rows.unbind(0), D))
        out.append(torch.stack(_state_tuple_to_rows(m, P)))
    return torch.stack(out, dim=1)


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
def phase1_aggregate(y_blocked, s_blocked, packed, D):
    """(L, B) y and noise streams -> (K, B) block aggregate elements."""
    if _route(y_blocked, s_blocked, packed) == "cpu":
        return phase1_aggregate_plain(y_blocked, s_blocked, packed, D)
    _check_kernel_args(D, y_blocked, s_blocked, packed)
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    out = torch.empty((elem_rows(D), B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase1_aggregate", (y_blocked, s_blocked, packed, out),
            (L, B, D, PHASE1_AGGREGATE_CHUNKS))
    phase1_aggregate.launches += 1
    return out


phase1_aggregate.launches = 0


# K2. Replaces temporalgps_tpu/ops/pallas_kernels.py phase2_starts
# (_phase2_kernel). One thread block of 128 threads. The TPU kernel holds all
# (K, B) aggregates in VMEM; here that would be 540 KB at B = 2048 in
# float64, above the 227 KB of shared memory a block may have, so the scan is
# two-level: each thread folds a contiguous run of ceil(B/128) aggregates,
# the 128 partials are scanned in shared memory (K x 128 values, 34 KB in
# float64), and each thread re-folds its run from its exclusive prefix,
# seeded with the prior, writing the starts. It works for any B. Bound by
# latency: ceil(B/128) + 7 + ceil(B/128) dependent combines on one SM.
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
# (_phase3_kernel). One thread per block runs the predict + scalar-update
# recursion from its start state over its L steps and writes its summed log
# marginal likelihood; the sum over blocks and the padding compensation stay
# outside (ops/block.py). Bound, like K1, by the latency of the serial
# recursion at B threads; a step is 215 dependent flops at D = 3, under a
# third of K1's, with the same one-warp-per-block spread.
def phase3_lml(y_blocked, s_blocked, packed, starts, D):
    """(L, B) streams and (SD, B) start states -> (B,) per-block lml."""
    if _route(y_blocked, s_blocked, packed, starts) == "cpu":
        return phase3_lml_plain(y_blocked, s_blocked, packed, starts, D)
    _check_kernel_args(D, y_blocked, s_blocked, packed, starts)
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    _check_shape("starts", starts, (state_rows(D), B))
    out = torch.empty((B,), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_lml", (y_blocked, s_blocked, packed, starts, out), (L, B, D))
    phase3_lml.launches += 1
    return out


phase3_lml.launches = 0

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
# cluster (`phase1_jvp_plain(..., chunks=C)` is the same schedule).
def phase1_jvp(y_blocked, s_blocked, packed_rows, D, k):
    """(L, B) streams and (1+k, PK2) parameter rows -> ((1+k)*K, B): the
    primal block aggregates followed by the k tangent sets."""
    _check_kernel_args(D, y_blocked, s_blocked, packed_rows)
    _check_streams(y_blocked, s_blocked)
    _check_jvp_rows(packed_rows, D, k)
    if _route(y_blocked, s_blocked, packed_rows) == "cpu":
        return phase1_jvp_plain(y_blocked, s_blocked, packed_rows, D, k)
    L, B = y_blocked.shape
    out = torch.empty(((1 + k) * elem_rows(D), B), dtype=y_blocked.dtype,
                      device=y_blocked.device)
    _launch("phase1_jvp", (y_blocked, s_blocked, packed_rows, out),
            (L, B, D, k, PHASE1_JVP_CHUNKS))
    phase1_jvp.launches += 1
    return out


phase1_jvp.launches = 0


# K5. Replaces temporalgps_tpu/ops/pallas_kernels.py phase2_jvp_starts
# (_phase2_jvp_kernel). The reference scans all 1+k element sets in one
# program in VMEM; here thread block j of k scans the primal and tangent j
# together with K2's two-level schedule, so shared memory holds two element
# sets whatever k is (67,584 B in float64 at D = 3: dynamic shared memory,
# with the attribute raised at the launch). Bound by bytes ((1+k)(K + SD) B
# values moved, one combine a block and tangent), and in practice by the
# latency of 2 ceil(B/128) + 7 dependent combines.
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
# for the primal and 406 for each tangent), and in practice by the latency
# of the serial recursion.
def phase3_jvp_lml(y_blocked, s_blocked, packed_rows, starts, D, k):
    """(L, B) streams, (1+k, PK2) rows and ((1+k)*SD, B) starts -> (1+k, B):
    the per-block lml followed by its k tangents."""
    _check_kernel_args(D, y_blocked, s_blocked, packed_rows, starts)
    _check_streams(y_blocked, s_blocked)
    _check_jvp_rows(packed_rows, D, k)
    L, B = y_blocked.shape
    _check_shape("starts", starts, ((1 + k) * state_rows(D), B))
    if _route(y_blocked, s_blocked, packed_rows, starts) == "cpu":
        return phase3_jvp_lml_plain(y_blocked, s_blocked, packed_rows, starts, D, k)
    out = torch.empty((1 + k, B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_jvp_lml", (y_blocked, s_blocked, packed_rows, starts, out), (L, B, D, k))
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
    _check_kernel_args(D, y_blocked, s_blocked, packed, starts)
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    _check_shape("starts", starts, (state_rows(D), B))
    out = torch.empty((state_rows(D), L, B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_states", (y_blocked, s_blocked, packed, starts, out),
            (L, B, D, PHASE3_STATES_CHUNKS))
    phase3_states.launches += 1
    return out


phase3_states.launches = 0


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
def affine_phase1(params, D):
    """(KT, L, B) affine maps -> (KT, B) block aggregates."""
    if _route(params) == "cpu":
        return affine_phase1_plain(params, D)
    _check_kernel_args(D, params)
    _check_affine_params(params, D)
    _, L, B = params.shape
    out = torch.empty((affine_rows(D), B), dtype=params.dtype, device=params.device)
    _launch("affine_phase1", (params, out), (L, B, D, AFFINE_PHASE1_CHUNKS))
    affine_phase1.launches += 1
    return out


affine_phase1.launches = 0


# K9. Replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase2_starts
# (_affine_phase2_kernel). The TPU kernel holds all (KT, B) aggregates in
# VMEM (344 KB at B = 2048 in float64, above the 227 KB of shared memory a
# thread block may have), so this is K2's two-level scan: one thread block of
# 128 threads, each folding a contiguous run, an inclusive scan of the 128
# partials in shared memory (KT x 128 values, 21.5 KB in float64), and each
# thread re-folding its run from its exclusive prefix, seeded with x0. Bound
# by latency: ceil(B/128) + 7 + ceil(B/128) dependent combines on one SM.
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
# (_affine_phase3_kernel). One thread per block replays m <- A m + b,
# P <- sym(A P A^T) + C from its start, reading KT rows and writing SD rows
# a step, each row a coalesced warp access; one warp per thread block.
# Bound by bytes on paper ((KT + SD) values a step), in practice by the
# serial replay's latency at B threads.
def affine_phase3_states(params, starts, D):
    """(KT, L, B) affine maps and (SD, B) start states -> (SD, L, B) states
    after every step."""
    if _route(params, starts) == "cpu":
        return affine_phase3_states_plain(params, starts, D)
    _check_kernel_args(D, params, starts)
    _check_affine_params(params, D)
    _, L, B = params.shape
    _check_shape("starts", starts, (state_rows(D), B))
    out = torch.empty((state_rows(D), L, B), dtype=params.dtype, device=params.device)
    _launch("affine_phase3_states", (params, starts, out), (L, B, D))
    affine_phase3_states.launches += 1
    return out


affine_phase3_states.launches = 0

WRAPPERS = (phase1_aggregate, phase2_starts, phase3_lml,
            phase1_jvp, phase2_jvp_starts, phase3_jvp_lml,
            phase3_states, affine_phase1, affine_phase2_starts, affine_phase3_states)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
