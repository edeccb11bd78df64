"""The block-parallel Kalman filter's three phases (csrc/block_phases.cu) and
their forward-mode twins, which carry k tangents beside the primal
(csrc/block_phases_jvp.cu), as kernels written by hand for Hopper, each
beside its plain PyTorch version.

Layout, as in temporalgps_tpu/ops/pallas_kernels.py: B blocks of L steps;
y and s are (L, B) streams (row l holds step l of every block); elements and
states are component-major, (rows, B):

    element rows (K = 3D^2 + 2D):  A (D*D, row-major), b (D), C (D*D), eta (D), J (D*D)
    state rows   (SD = D + D^2):   m (D), P (D*D, row-major)
    packed params (PK = 2D^2 + 2D + 1):  A (D*D), a (D), Q (D*D), H (D), h

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
_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def elem_rows(D: int) -> int:
    return 3 * D * D + 2 * D


def state_rows(D: int) -> int:
    return D + D * D


def param_len(D: int) -> int:
    return 2 * D * D + 2 * D + 1


def param_s_len(D: int) -> int:
    return param_len(D) + 1


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
    "phase1_aggregate": (4, 3),  # y, s, params, out; L, B, D
    "phase2_starts": (3, 2),     # comps, prior, starts; B, D
    "phase3_lml": (5, 3),        # y, s, params, starts, lml; L, B, D
    "phase1_jvp": (4, 4),         # y, s, rows, out; L, B, D, k
    "phase2_jvp_starts": (3, 3),  # comps, priors, starts; B, D, k
    "phase3_jvp_lml": (5, 4),     # y, s, rows, starts, lml; L, B, D, k
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


def _elem_rows_to_tuple(rows, D):
    DD = D * D
    A = tuple(tuple(rows[r * D + c] for c in range(D)) for r in range(D))
    b = tuple(rows[DD + i] for i in range(D))
    C = tuple(tuple(rows[DD + D + r * D + c] for c in range(D)) for r in range(D))
    eta = tuple(rows[2 * DD + D + i] for i in range(D))
    J = tuple(tuple(rows[2 * DD + 2 * D + r * D + c] for c in range(D)) for r in range(D))
    return (A, b, C, eta, J)


def _elem_tuple_to_rows(e):
    A, b, C, eta, J = e
    return [*(x for row in A for x in row), *b, *(x for row in C for x in row),
            *eta, *(x for row in J for x in row)]


def phase1_aggregate_plain(y_blocked, s_blocked, packed, D):
    """(L, B) streams -> (K, B) block aggregates: for each block, the left
    fold of its L step elements from the identity element."""
    L, B = y_blocked.shape
    A, a, Q, H, h = _unpack_params(packed, D)
    carry = _identity_elem((B,), D, y_blocked)
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        carry = lanes.combine(carry, lanes.step_element(A, a, Q, H, h, s_l, y_l, 1.0, 0.0))
    return torch.stack(_elem_tuple_to_rows(carry))


def _shift(e, k, diag=1.0):
    """Shift every component right by k blocks (the last axis), filling with
    the identity element, or with its tangent, all zeros, for diag=0."""
    def go(comp, fill):
        front = comp.new_full((*comp.shape[:-1], k), fill)
        return torch.cat([front, comp[..., : comp.shape[-1] - k]], dim=-1)

    A, b, C, eta, J = e
    D = len(b)
    zmat = lambda M: tuple(tuple(go(x, 0.0) for x in row) for row in M)
    A_s = tuple(tuple(go(A[r][c], diag if r == c else 0.0) for c in range(D)) for r in range(D))
    return (A_s, tuple(go(x, 0.0) for x in b), zmat(C), tuple(go(x, 0.0) for x in eta), zmat(J))


def phase2_starts_plain(comps, x0_mean, x0_cov, D):
    """(K, B) aggregates -> (SD, B) block-start states,
    starts[b] = prior ∘ agg_0 ∘ ... ∘ agg_{b-1} with prior (0, m0, P0, 0, 0).
    The prefix is the reference kernel's inclusive Kogge-Stone scan over the
    blocks, earlier operand on the left at every level (combine is not
    commutative), then shifted to exclusive and seeded with the prior."""
    B = comps.shape[1]
    e = _elem_rows_to_tuple(comps.unbind(0), D)
    k = 1
    while k < B:
        e = lanes.combine(_shift(e, k), e)
        k *= 2
    e = _shift(e, 1)
    zero = comps.new_zeros(())
    zmat = tuple(tuple(zero for _ in range(D)) for _ in range(D))
    m0 = tuple(x0_mean.unbind(0))
    P0 = tuple(tuple(row.unbind(0)) for row in x0_cov.unbind(0))
    _, b, C, _, _ = lanes.combine((zmat, m0, P0, (zero,) * D, zmat), e)
    return torch.stack([*b, *(x for row in C for x in row)])


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


def _state_rows_to_tuple(rows, D):
    m = tuple(rows[:D])
    P = tuple(tuple(rows[D + r * D + c] for c in range(D)) for r in range(D))
    return m, P


def phase1_jvp_plain(y_blocked, s_blocked, packed_rows, D, k):
    """(L, B) streams and (1+k, PK2) rows -> ((1+k)*K, B): the primal block
    aggregates followed by their k tangents. The noise tangent of a step is
    masked to zero where the streamed s marks it missing or padding."""
    L, B = y_blocked.shape
    primal, tangent, ds = _unpack_rows(packed_rows, D, k)
    slot = torch.zeros_like(ds)
    carry = _identity_elem((k, B), D, y_blocked)
    dcarry = _zero_elem((k, B), D, y_blocked)
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        mask = (s_l < _MASK_THRESH).to(s_l.dtype)

        def fold(carry, A, a, Q, H, h, slot):
            step = lanes.step_element(A, a, Q, H, h, s_l + slot * mask, y_l, 1.0, 0.0)
            return lanes.combine(carry, step)

        carry, dcarry = torch.func.jvp(fold, (carry, *primal, slot), (dcarry, *tangent, ds))
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
    return _stack_sets([*b, *(x for row in C for x in row)],
                       [*db, *(x for row in dC for x in row)])


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
# Wrappers
# ---------------------------------------------------------------------------

# K1. Replaces temporalgps_tpu/ops/pallas_kernels.py phase1_aggregate
# (_phase1_kernel). One thread per block: it folds its L steps serially,
# reading y[l, b] and s[l, b] (a warp reads 32 neighbouring addresses) and
# keeping the K-component element in registers. Bound by the latency of that
# serial recursion: at B = 2048 only 2048 threads are in flight on 132 SMs,
# and the 2 N values read are nothing next to the 738 dependent flops a
# step (D = 3). The design spreads the threads one warp per block, so each warp gets
# an SM scheduler of its own; more parallelism (larger B) is later work.
def phase1_aggregate(y_blocked, s_blocked, packed, D):
    """(L, B) y and noise streams -> (K, B) block aggregate elements."""
    if _route(y_blocked, s_blocked, packed) == "cpu":
        return phase1_aggregate_plain(y_blocked, s_blocked, packed, D)
    _check_kernel_args(D, y_blocked, s_blocked, packed)
    _check_streams(y_blocked, s_blocked)
    _check_shape("packed params", packed, (param_len(D),))
    L, B = y_blocked.shape
    out = torch.empty((elem_rows(D), B), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase1_aggregate", (y_blocked, s_blocked, packed, out), (L, B, D))
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
    prior = torch.cat([x0_mean.reshape(-1), x0_cov.reshape(-1)]).to(comps.dtype)
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
# and combine are written out (csrc/lanes.cuh). Thread (b, j) of a
# (ceil(B/32), k) grid folds block b's L steps for the primal and tangent j;
# the primal is recomputed k times rather than held with k tangents in one
# thread, which registers forbid and a runtime k cannot unroll. Bound by
# operations (at D = 3, 738 flops a step for the primal and 1522 for each
# tangent, against 2 values read), and in practice by the latency of the
# serial recursion at k*B threads.
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
    _launch("phase1_jvp", (y_blocked, s_blocked, packed_rows, out), (L, B, D, k))
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

WRAPPERS = (phase1_aggregate, phase2_starts, phase3_lml,
            phase1_jvp, phase2_jvp_starts, phase3_jvp_lml)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
