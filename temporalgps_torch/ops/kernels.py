"""The block-parallel Kalman filter's three phases as kernels written by hand
for Hopper (csrc/block_phases.cu), each beside its plain PyTorch version.

Layout, as in temporalgps_tpu/ops/pallas_kernels.py: B blocks of L steps;
y and s are (L, B) streams (row l holds step l of every block); elements and
states are component-major, (rows, B):

    element rows (K = 3D^2 + 2D):  A (D*D, row-major), b (D), C (D*D), eta (D), J (D*D)
    state rows   (SD = D + D^2):   m (D), P (D*D, row-major)
    packed params (PK = 2D^2 + 2D + 1):  A (D*D), a (D), Q (D*D), H (D), h

Each wrapper runs the plain version when its tensors are on the CPU, and
launches its kernel when they are on a CUDA device; there is no other route.
It counts its kernel launches in `<wrapper>.launches`.

The kernels are compiled with nvcc at first use into a shared library with a
plain C interface under temporalgps_torch/_build/, keyed by a hash of the
sources and flags, and loaded with ctypes.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def elem_rows(D: int) -> int:
    return 3 * D * D + 2 * D


def state_rows(D: int) -> int:
    return D + D * D


def param_len(D: int) -> int:
    return 2 * D * D + 2 * D + 1


def pack_params(A, a, Q, H, h, dtype):
    """(PK,) tensor of the time-invariant transition and emission."""
    return torch.cat(
        [A.reshape(-1), a.reshape(-1), Q.reshape(-1), H.reshape(-1), h.reshape(1)]
    ).to(dtype)


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


def build() -> Path:
    """Compile csrc/*.cu into the shared library, unless a library built from
    the same sources and flags exists; return its path. The compiler's output
    (ptxas register and spill counts) is kept beside it with suffix .log."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"libtgps_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp_path = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp_path, lib_path)
    return lib_path


_ENTRY_ARGS = {
    # pointers, then ints, then the stream
    "phase1_aggregate": (4, 3),  # y, s, params, out; L, B, D
    "phase2_starts": (3, 2),     # comps, prior, starts; B, D
    "phase3_lml": (5, 3),        # y, s, params, starts, lml; L, B, D
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


def _check_streams(y_blocked, s_blocked, packed, D):
    if y_blocked.ndim != 2:
        raise ValueError(f"y_blocked must be (L, B), got shape {tuple(y_blocked.shape)}")
    _check_shape("s_blocked", s_blocked, y_blocked.shape)
    _check_shape("packed params", packed, (param_len(D),))


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


def _identity_elem(B, D, like):
    ones, zeros = like.new_ones(B), like.new_zeros(B)
    zmat = tuple(tuple(zeros for _ in range(D)) for _ in range(D))
    return (lanes.eye(D, ones, zeros), (zeros,) * D, zmat, (zeros,) * D, zmat)


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
    carry = _identity_elem(B, D, y_blocked)
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        carry = lanes.combine(carry, lanes.step_element(A, a, Q, H, h, s_l, y_l, 1.0, 0.0))
    return torch.stack(_elem_tuple_to_rows(carry))


def _shift(e, k):
    """Shift every component right by k blocks, filling with the identity."""
    def go(comp, fill):
        return torch.cat([comp.new_full((k,), fill), comp[: comp.shape[0] - k]])

    A, b, C, eta, J = e
    D = len(b)
    zmat = lambda M: tuple(tuple(go(x, 0.0) for x in row) for row in M)
    A_s = tuple(tuple(go(A[r][c], 1.0 if r == c else 0.0) for c in range(D)) for r in range(D))
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
    rows = starts.unbind(0)
    m = tuple(rows[:D])
    P = tuple(tuple(rows[D + r * D + c] for c in range(D)) for r in range(D))
    acc = y_blocked.new_zeros(B)
    for y_l, s_l in zip(y_blocked.unbind(0), s_blocked.unbind(0)):
        m, P, lml = lanes.kalman_step(m, P, A, a, Q, H, h, s_l, y_l)
        acc = acc + lml
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

# K1. Replaces temporalgps_tpu/ops/pallas_kernels.py phase1_aggregate
# (_phase1_kernel). One thread per block: it folds its L steps serially,
# reading y[l, b] and s[l, b] (a warp reads 32 neighbouring addresses) and
# keeping the K-component element in registers. Bound by the latency of that
# serial recursion: at B = 2048 only 2048 threads are in flight on 132 SMs,
# and the 2 N values read are nothing next to the ~600 dependent flops a
# step. The design spreads the threads one warp per block, so each warp gets
# an SM scheduler of its own; more parallelism (larger B) is later work.
def phase1_aggregate(y_blocked, s_blocked, packed, D):
    """(L, B) y and noise streams -> (K, B) block aggregate elements."""
    if _route(y_blocked, s_blocked, packed) == "cpu":
        return phase1_aggregate_plain(y_blocked, s_blocked, packed, D)
    _check_kernel_args(D, y_blocked, s_blocked, packed)
    _check_streams(y_blocked, s_blocked, packed, D)
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
# recursion at B threads; a step is ~100 dependent flops, about a sixth of
# K1's, with the same one-warp-per-block spread.
def phase3_lml(y_blocked, s_blocked, packed, starts, D):
    """(L, B) streams and (SD, B) start states -> (B,) per-block lml."""
    if _route(y_blocked, s_blocked, packed, starts) == "cpu":
        return phase3_lml_plain(y_blocked, s_blocked, packed, starts, D)
    _check_kernel_args(D, y_blocked, s_blocked, packed, starts)
    _check_streams(y_blocked, s_blocked, packed, D)
    L, B = y_blocked.shape
    _check_shape("starts", starts, (state_rows(D), B))
    out = torch.empty((B,), dtype=y_blocked.dtype, device=y_blocked.device)
    _launch("phase3_lml", (y_blocked, s_blocked, packed, starts, out), (L, B, D))
    phase3_lml.launches += 1
    return out


phase3_lml.launches = 0

WRAPPERS = (phase1_aggregate, phase2_starts, phase3_lml)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
