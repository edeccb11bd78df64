"""Smoke run of the PyTorch port (temporalgps_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final result line:
  1. torch / CUDA versions, and the card's name and power limit (nvidia-smi).
  2. Build the hand-written kernels (csrc/, one nvcc per source, side by
     side) and report the build time, ptxas register / shared-memory /
     spill counts, and K1's, K4's, K7's and K8's chunk counts.
  3. Each value kernel (K1 phase1_aggregate, K2 phase2_starts, K3 phase3_lml)
     against its plain PyTorch version on the card, at the main path's shapes
     (Matern-5/2, D = 3, N = 1M: B = 2048 blocks of L = 489 steps), float64
     and float32. The gate is on the per-block lml partials downstream of the
     kernel: relative 1e-10 in float64, 1e-4 in float32 (the kernel and the
     plain version round and contract to FMA differently). K1's plain
     version runs in K1's chunk order (kernels.PHASE1_AGGREGATE_CHUNKS), and
     K1 is also held at phase 4's two ragged shapes.
  4. Each forward-mode kernel (K4 phase1_jvp, K5 phase2_jvp_starts, K6
     phase3_jvp_lml) against its plain version (PyTorch's forward-mode
     autodiff of the plain loops) at the training path's shapes (the same
     streams, k = 3 tangents). The gate is on the (1+k, B) lml rows
     downstream, each row scaled by its own largest entry, with the same two
     tolerances for the same reason: the kernels' tangents are written out by
     hand and contract to FMA, the plain ones come from autodiff. K4's
     plain version runs in K4's chunk order (kernels.PHASE1_JVP_CHUNKS).
     K4 is also held, with the same gate, at two ragged shapes of B = 96
     blocks: L = 37 (not a multiple of the chunk count) and L = 1 (fewer
     steps than chunks), with a missing step and padding steps.
  5. The lml path, through the public entry points:
       to_sde(GP((s2*Matern52()).stretch(sc)), ArrayStorage(float32))(
           RegularSpacing(0, 1e-3, 1_000_000), 0.1) -> logpdf
     with one missing (NaN) observation. K1-K3's launch counts must move.
     The float32 lml must be within 1e-3 relative of the float64 plain
     blocked schedule; the float64 kernel path within 1e-10 of it and, at
     N = 20k, within 1e-9 of the port's sequential engine (on the CPU); the
     gradient through the fused autograd.Function must match the plain
     schedule's (1e-10) and the sequential engine's (1e-6). Where the time
     of one logpdf call at N = 1M goes: torch.profiler over 10 calls
     (device busy by kernel, idle share), float32 and float64.
  6. The training path, through the public entry points:
       vg = value_and_grad_fwd_lgssm(model_fn, y); vg(p0)
     at N = 1M in float32 with k = 3 hyperparameters (log sigma^2, log
     stretch, log noise). K4-K6's launch counts must move. Value within 1e-3
     relative of the float64 run, which equals logpdf on K1-K3 (1e-10);
     float64 gradient at N = 20k within 1e-6 of the sequential engine's
     autograd gradient on the CPU and within 1e-8 of the plain forward-mode
     schedule; float32 gradient at N = 1M within 1e-3 of the float64 one per
     component, with an absolute floor of 1e-6 of the largest component
     (the components are sums over the same steps, so their float32 rounding
     shares that scale), printed beside the components' sizes; a model the
     kernels do not take (irregular times) raises on the card; three Adam
     steps on vg at N = 1M with finite, decreasing loss; and fit() at
     N = 20k on vg and on autograd, which must agree.
  7. Time each kernel (median of 5 batches of 10 calls) and its plain
     version (one call), the end-to-end logpdf and the end-to-end vg(p0),
     with CUDA events, float32 and float64, at N = 1M; and work out each
     kernel's bound from this run's shapes.
  8. Where the time of one vg(p0) call goes: torch.profiler over 10 calls
     (device busy by kernel, idle share) and host-clock stages.
  9. The state-emitting kernels (K7 phase3_states, K8 affine_phase1, K9
     affine_phase2_starts, K10 affine_phase3_states) against their plain
     versions at the main shapes (D = 3, N = 1M, B = 2048, L = 489), float64
     and float32. K7 takes the lml path's streams; K8-K10 take the affine
     rows of the N = 1M posterior of phase 10 (the reverse model's
     iteration view). The gate is on the state rows (K7's and K10's own,
     and those the plain phases compute downstream of K8 and K9), each row
     scaled by its largest entry: 1e-10 in float64, 1e-4 in float32, for
     the rounding and FMA reason of phase 3. K7's and K8's plain versions
     run in their kernels' chunk order (kernels.PHASE3_STATES_CHUNKS,
     AFFINE_PHASE1_CHUNKS); K7 is also held at phase 4's two ragged shapes
     (a missing step and padding steps), K8 at the same shapes on
     time-varying maps.
 10. The posterior path, through the public entry points:
       marginals(posterior(fx, y)(x, 0.1))   (temporalgps_torch.gp.posterior)
     for the reference's bench config c1 (GP(Matern32()), float32,
     RegularSpacing(0, 1e-3, 10_000), noise 0.1, y from default_rng(0)) and
     for the main model (phase 5's, N = 1M, one NaN) in both dtypes, and
     the prior marginals(fx). K1, K2, K7 and K8-K10 must launch on the
     posterior call, K3 must not. Gates: c1 float32 within 1e-3 relative of
     float64; float64 on the card within 1e-9 of the port's sequential
     engine on the CPU at N = 20k; at N = 1M the float32 error against
     float64 is printed beside the sizes it compares, with finite values and
     positive variances gated; a posterior at new times (2k training and 500
     prediction times, interleaved: the sequential filter, then K8-K10) on
     the card within 1e-9 of the CPU in float64; cov refuses.
 11. Time K7-K10 as phase 7 does, each plain version once, and the
     end-to-end posterior-marginals call at c1 and at N = 1M, with each
     kernel's bound from this run's shapes.
 12. Where the time of one posterior-marginals call at N = 1M goes:
     torch.profiler over 10 calls (device busy by kernel, idle share, the
     count of other device kernels) and host-clock stages (build_lgssm,
     missing data, K1/K2/K7, the reversal of the dynamics, the affine rows,
     K8-K10, the projection).

The third line from the end is the card's name and power limit, the second
{"kernels": [...]} with the float32 (main path) numbers of all ten kernels,
the last {"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
N_MAIN = 1_000_000
N_SMALL = 20_000
NAN_AT = 123_456
SEED = 0
S2, SC, NOISE = 1.0, 1.0, 0.1
D_MAIN, K_TANGENTS = 3, 3
SOURCES = {
    "phase1_aggregate": "temporalgps_torch/csrc/block_phases.cu",
    "phase2_starts": "temporalgps_torch/csrc/block_phases.cu",
    "phase3_lml": "temporalgps_torch/csrc/block_phases.cu",
    "phase1_jvp": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase2_jvp_starts": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase3_jvp_lml": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase3_states": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase1": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase2_starts": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase3_states": "temporalgps_torch/csrc/block_states.cu",
}
REPLACES = {
    "phase1_aggregate": "temporalgps_tpu/ops/pallas_kernels.py:227",
    "phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:335",
    "phase3_lml": "temporalgps_tpu/ops/pallas_kernels.py:731",
    "phase1_jvp": "temporalgps_tpu/ops/pallas_kernels.py:471",
    "phase2_jvp_starts": "temporalgps_tpu/ops/pallas_kernels.py:563",
    "phase3_jvp_lml": "temporalgps_tpu/ops/pallas_kernels.py:641",
    "phase3_states": "temporalgps_tpu/ops/pallas_kernels.py:810",
    "affine_phase1": "temporalgps_tpu/ops/pallas_kernels.py:905",
    "affine_phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:974",
    "affine_phase3_states": "temporalgps_tpu/ops/pallas_kernels.py:1017",
}
VALUE_KERNELS = ("phase1_aggregate", "phase2_starts", "phase3_lml")
JVP_KERNELS = ("phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml")
STATE_KERNELS = ("phase3_states", "affine_phase1", "affine_phase2_starts", "affine_phase3_states")
POSTERIOR_KERNELS = ("phase1_aggregate", "phase2_starts") + STATE_KERNELS
N_C1 = 10_000
N_TRAIN_NEW, N_PRED_NEW = 2_000, 500
KERNEL_RTOL = {"float64": 1e-10, "float32": 1e-4}

# Ragged (L, B) of the chunked kernels (K1, K4, K7, K8) beside the main
# shapes: L not a multiple of the chunk counts, and fewer steps than chunks.
RAGGED_SHAPES = ((37, 96), (1, 96))

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and arithmetic outside the tensor cores (float64 is half the float32 rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
ITEMSIZE = {"float32": 4, "float64": 8}


# ---------------------------------------------------------------------------
# Operation counts: the multiplies, adds, divides and logs of
# temporalgps_torch/csrc/lanes.cuh, line by line, as functions of D.
# ---------------------------------------------------------------------------

def _op_counts(D):
    return dict(mm=D * D * (2 * D - 1), mv=D * (2 * D - 1), dot=2 * D - 1, outer=D * D,
                madd=D * D, mscale=D * D, sym=2 * D * D, vadd=D, vscale=D,
                inv={1: 1, 2: 8, 3: 42}[D])


def flops_step_element(D):
    c = _op_counts(D)
    return (2 * c["mv"] + 2 * c["dot"] + 5 + 3 * c["vscale"] + 2 * c["outer"] + c["madd"]
            + 2 * c["mm"] + c["vadd"] + c["sym"] + c["mscale"])


def flops_step_element_tangent(D):
    c = _op_counts(D)
    return (4 * c["mv"] + 4 * c["dot"] + 11 + 6 * c["vscale"] + 6 * c["vadd"] + 4 * c["outer"]
            + 6 * c["madd"] + 4 * c["mm"] + c["sym"] + 2 * c["mscale"])


def flops_combine(D):
    c = _op_counts(D)
    return (8 * c["mm"] + 3 * c["madd"] + c["inv"] + 4 * c["mv"] + 4 * c["vadd"]
            + 2 * c["sym"])


def flops_combine_tangent(D):
    c = _op_counts(D)
    return 18 * c["mm"] + 11 * c["madd"] + 8 * c["mv"] + 8 * c["vadd"] + 2 * c["sym"]


def flops_kalman_step(D):
    c = _op_counts(D)
    return (2 * c["mv"] + 2 * c["vadd"] + 2 * c["mm"] + 2 * c["sym"] + 2 * c["madd"]
            + 2 * c["dot"] + 10 + 2 * c["vscale"] + c["outer"])


def flops_kalman_step_tangent(D):
    c = _op_counts(D)
    return (4 * c["mv"] + 6 * c["vadd"] + 4 * c["mm"] + 5 * c["madd"] + 2 * c["sym"]
            + 4 * c["dot"] + 17 + 4 * c["vscale"] + 2 * c["outer"])


def flops_kalman_state_step(D):
    """kalman_step without its lml (a log, two adds, a multiply, a divide
    and the -0.5 scale), which phase3_states does not keep."""
    return flops_kalman_step(D) - 6


def flops_affine_combine(D):
    c = _op_counts(D)
    return 3 * c["mm"] + c["mv"] + c["vadd"] + c["sym"] + c["madd"]


def flops_affine_step(D):
    c = _op_counts(D)
    return 2 * c["mm"] + c["mv"] + c["vadd"] + c["sym"] + c["madd"]


def kernel_work(name, L, B, D, k):
    """(operations, values moved) of one call: the primal once and each of
    the k tangents once; every input read once, every output written once."""
    K, SD, PK = 3 * D * D + 2 * D, D + D * D, 2 * D * D + 2 * D + 1
    KT = 2 * D * D + D
    steps = L * B
    if name == "phase1_aggregate":
        return steps * (flops_step_element(D) + flops_combine(D)), 2 * steps + PK + K * B
    if name == "phase2_starts":
        return B * flops_combine(D), K * B + SD + SD * B
    if name == "phase3_lml":
        return steps * flops_kalman_step(D), 2 * steps + PK + SD * B + B
    if name == "phase1_jvp":
        ops = (flops_step_element(D) + flops_combine(D)
               + k * (flops_step_element_tangent(D) + flops_combine_tangent(D)))
        return steps * ops, 2 * steps + (1 + k) * (PK + 1) + (1 + k) * K * B
    if name == "phase2_jvp_starts":
        return (B * (flops_combine(D) + k * flops_combine_tangent(D)),
                (1 + k) * (K * B + SD + SD * B))
    if name == "phase3_jvp_lml":
        ops = flops_kalman_step(D) + k * flops_kalman_step_tangent(D)
        return steps * ops, 2 * steps + (1 + k) * (PK + 1) + (1 + k) * (SD * B + B)
    if name == "phase3_states":
        return steps * flops_kalman_state_step(D), 2 * steps + PK + SD * B + SD * steps
    if name == "affine_phase1":
        return steps * flops_affine_combine(D), KT * steps + KT * B
    if name == "affine_phase2_starts":
        return B * flops_affine_combine(D), KT * B + SD + SD * B
    if name == "affine_phase3_states":
        return steps * flops_affine_step(D), KT * steps + SD * B + SD * steps
    raise KeyError(name)


def kernel_bound(name, dtype_name, L, B, D, k):
    """(bound_ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak rate for the dtype."""
    ops, values = kernel_work(name, L, B, D, k)
    ops_ms = 1e3 * ops / PEAK_FLOPS[dtype_name]
    bytes_ms = 1e3 * values * ITEMSIZE[dtype_name] / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class Smoke:
    def __init__(self):
        self.failures = []
        self.record = {}

    def check(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase is reported, the later ones still run
            traceback.print_exc()
            self.failures.append(f"{name}: exception")
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def rel(a, b):
    return abs(a - b) / abs(b)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from temporalgps_torch import (RegularSpacing, fit, learning, logpdf, marginals,
                                   value_and_grad_fwd_lgssm)
    from temporalgps_torch.gp import GP, ArrayStorage, Matern32, Matern52, to_sde
    from temporalgps_torch.gp import posterior as gpost
    from temporalgps_torch.gp.lti_sde import build_lgssm
    from temporalgps_torch.models.missings import (posterior_with_missings,
                                                   replace_observation_noise_cov,
                                                   transform_model_and_obs)
    from temporalgps_torch.ops import block, kernels
    from temporalgps_torch.utils.psd import symmetrize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    D, k = D_MAIN, K_TANGENTS

    y_np = np.random.default_rng(SEED).standard_normal(N_MAIN)
    y_np[NAN_AT] = np.nan
    y_dev = {name: torch.as_tensor(y_np, dtype=dtype, device=DEVICE)
             for name, dtype in dtypes.items()}
    p0 = torch.tensor([math.log(S2), math.log(SC), math.log(NOISE)], dtype=torch.float64,
                      device=DEVICE)

    def make_fx(dtype, N, device, s2=S2, sc=SC, noise=NOISE):
        kern = (s2 * Matern52()).stretch(sc)
        return to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, N), noise)

    def make_model_fn(dtype, N, device):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            return build_lgssm(make_fx(dtype, N, device, s2=s2, sc=sc, noise=noise))

        return model_fn

    def events_ms(fn, reps, batches, warm_up=True):
        """Median and range over `batches` of the ms per call, each batch
        `reps` calls between two CUDA events, after one warm-up call."""
        if warm_up:
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times), min(times), max(times)

    # ---- 1. versions and card -------------------------------------------
    def phase_versions():
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
              f"count {torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        smoke.check(smi.returncode == 0 and bool(smi.stdout.strip()),
                    f"nvidia-smi exit {smi.returncode}")
        smoke.record["card"] = smi.stdout.strip().splitlines()[0]

    # ---- 2. build ---------------------------------------------------------
    def phase_build():
        t0 = time.perf_counter()
        path = kernels.build()
        kernels._library()
        print(f"  built {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.1f} s")
        smoke.record["chunks"] = {"phase1_aggregate": kernels.PHASE1_AGGREGATE_CHUNKS,
                                  "phase1_jvp": kernels.PHASE1_JVP_CHUNKS,
                                  "phase3_states": kernels.PHASE3_STATES_CHUNKS,
                                  "affine_phase1": kernels.AFFINE_PHASE1_CHUNKS}
        print(f"  chunks a block: {smoke.record['chunks']}")
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(key in line for key in ("Compiling entry", "registers", "spill", "smem")):
                    print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- 3. value kernels against their plain versions -------------------
    def main_inputs(name):
        dtype = dtypes[name]
        model = build_lgssm(make_fx(dtype, N_MAIN, DEVICE))
        model, y, _comp = transform_model_and_obs(model, y_dev[name])
        A, a, Q, H, h, s, y, m0, P0 = block._fused_leaves(model, y)
        B = block._pallas_blocks(N_MAIN)
        y_main, s_main, _ = block._blocked_streams(y, s, B)
        packed = kernels.pack_params(A, a, Q, H, h, dtype)
        return y_main, s_main, packed, m0, symmetrize(P0)

    def record_comparison(kname, name, k_out, p_out, partials, want, label="lml-partials",
                          shape=None):
        """`partials` (downstream of the kernel) against `want`, row by row
        relative to each row's largest entry; recorded under the dtype's
        name, or beside it for a ragged (L, B) `shape`."""
        finite = bool(torch.isfinite(k_out).all())
        max_abs = (k_out - p_out).abs().max().item()
        scale = want.abs().amax(dim=-1, keepdim=True)
        r = ((partials - want).abs() / scale).max().item()
        key = name if shape is None else f"{name}_L{shape[0]}_B{shape[1]}"
        smoke.record.setdefault(kname, {})[key] = {"max_abs_err": max_abs,
                                                   f"{label.replace('-', '_')}_rel": r}
        smoke.check(finite and r <= KERNEL_RTOL[name],
                    f"{kname} {key}: finite={finite} max_abs_err={max_abs:.3e} "
                    f"{label} rel={r:.3e} (tol {KERNEL_RTOL[name]:g})")

    def ragged_streams(name, L, B):
        """(L, B) y and s on the card: a missing step, and padding steps at
        the end of the last block."""
        rng = np.random.default_rng(SEED + L)
        s = np.full((L, B), NOISE)
        s[min(5, L - 1), 7] = 1e15
        s[max(L - 2, 0):, B - 1] = 1e15
        return (torch.as_tensor(rng.standard_normal((L, B)), dtype=dtypes[name], device=DEVICE),
                torch.as_tensor(s, dtype=dtypes[name], device=DEVICE))

    def phase_compare():
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            smoke.record["shapes"] = {"L": L, "B": B, "D": D, "k": k}
            print(f"  {name}: L={L} B={B} D={D}")
            p1 = kernels.phase1_aggregate_plain(y_main, s_main, packed, D,
                                                chunks=kernels.PHASE1_AGGREGATE_CHUNKS)
            p2 = kernels.phase2_starts_plain(p1, m0, P0, D)
            p3 = kernels.phase3_lml_plain(y_main, s_main, packed, p2, D)
            k1 = kernels.phase1_aggregate(y_main, s_main, packed, D)
            k2 = kernels.phase2_starts(p1, m0, P0, D)
            k3 = kernels.phase3_lml(y_main, s_main, packed, p2, D)
            torch.cuda.synchronize()
            via_k1 = kernels.phase3_lml_plain(
                y_main, s_main, packed, kernels.phase2_starts_plain(k1, m0, P0, D), D)
            via_k2 = kernels.phase3_lml_plain(y_main, s_main, packed, k2, D)
            record_comparison("phase1_aggregate", name, k1, p1, via_k1, p3)
            record_comparison("phase2_starts", name, k2, p2, via_k2, p3)
            record_comparison("phase3_lml", name, k3, p3, k3, p3)
            for shape in RAGGED_SHAPES:
                y_r, s_r = ragged_streams(name, *shape)
                p1 = kernels.phase1_aggregate_plain(y_r, s_r, packed, D,
                                                    chunks=kernels.PHASE1_AGGREGATE_CHUNKS)
                p3 = kernels.phase3_lml_plain(
                    y_r, s_r, packed, kernels.phase2_starts_plain(p1, m0, P0, D), D)
                k1 = kernels.phase1_aggregate(y_r, s_r, packed, D)
                torch.cuda.synchronize()
                via_k1 = kernels.phase3_lml_plain(
                    y_r, s_r, packed, kernels.phase2_starts_plain(k1, m0, P0, D), D)
                record_comparison("phase1_aggregate", name, k1, p1, via_k1, p3, shape=shape)

    # ---- 4. forward-mode kernels against their plain versions ------------
    def jvp_inputs(name):
        """The streams, parameter rows and priors that vg(p0) hands K4-K6."""
        dtype = dtypes[name]
        model, tangents = learning._model_and_tangents(
            make_model_fn(dtype, N_MAIN, DEVICE), p0)
        model_f, y, _comp = transform_model_and_obs(model, y_dev[name])
        y_main, s_main, _ = block._blocked_streams(
            y, model_f.emis.s, block._pallas_blocks(N_MAIN))
        rows, priors = block._tangent_rows(model, tangents)
        return y_main, s_main, rows, priors

    def phase_compare_jvp():
        for name in dtypes:
            y_main, s_main, rows, priors = jvp_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D} k={k}")
            p1 = kernels.phase1_jvp_plain(y_main, s_main, rows, D, k,
                                          chunks=kernels.PHASE1_JVP_CHUNKS)
            p2 = kernels.phase2_jvp_starts_plain(p1, priors, D, k)
            p3 = kernels.phase3_jvp_lml_plain(y_main, s_main, rows, p2, D, k)
            k1 = kernels.phase1_jvp(y_main, s_main, rows, D, k)
            k2 = kernels.phase2_jvp_starts(p1, priors, D, k)
            k3 = kernels.phase3_jvp_lml(y_main, s_main, rows, p2, D, k)
            torch.cuda.synchronize()
            via_k1 = kernels.phase3_jvp_lml_plain(
                y_main, s_main, rows, kernels.phase2_jvp_starts_plain(k1, priors, D, k), D, k)
            via_k2 = kernels.phase3_jvp_lml_plain(y_main, s_main, rows, k2, D, k)
            record_comparison("phase1_jvp", name, k1, p1, via_k1, p3)
            record_comparison("phase2_jvp_starts", name, k2, p2, via_k2, p3)
            record_comparison("phase3_jvp_lml", name, k3, p3, k3, p3)
            for shape in RAGGED_SHAPES:
                y_r, s_r = ragged_streams(name, *shape)
                p1 = kernels.phase1_jvp_plain(y_r, s_r, rows, D, k,
                                              chunks=kernels.PHASE1_JVP_CHUNKS)
                p3 = kernels.phase3_jvp_lml_plain(
                    y_r, s_r, rows, kernels.phase2_jvp_starts_plain(p1, priors, D, k), D, k)
                k1 = kernels.phase1_jvp(y_r, s_r, rows, D, k)
                torch.cuda.synchronize()
                via_k1 = kernels.phase3_jvp_lml_plain(
                    y_r, s_r, rows, kernels.phase2_jvp_starts_plain(k1, priors, D, k), D, k)
                record_comparison("phase1_jvp", name, k1, p1, via_k1, p3, shape=shape)

    # ---- 5. lml path -----------------------------------------------------
    def phase_main_path():
        kernels.reset_launch_counts()
        fx = make_fx(torch.float32, N_MAIN, DEVICE)
        lml32 = logpdf(fx, y_dev["float32"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record["launches"] = {name: counts[name] for name in VALUE_KERNELS}
        print(f"  float32 N={N_MAIN} lml = {lml32.item()!r}, launches {counts}")
        smoke.check(all(counts[name] >= 1 for name in VALUE_KERNELS),
                    "K1-K3 launched on the lml path")
        smoke.check(lml32.shape == () and math.isfinite(lml32.item()), "float32 lml finite scalar")

        fx64 = make_fx(torch.float64, N_MAIN, DEVICE)
        lml64_plain = logpdf(fx64, y_dev["float64"], engine="block", fused=False).item()
        lml64 = logpdf(fx64, y_dev["float64"]).item()
        print(f"  float64 N={N_MAIN} kernels {lml64!r}, plain {lml64_plain!r}")
        r32 = rel(lml32.item(), lml64_plain)
        r64 = rel(lml64, lml64_plain)
        smoke.record["main_path"] = {"lml_f32": lml32.item(), "lml_f64": lml64,
                                     "lml_f64_plain": lml64_plain,
                                     "rel_f32_vs_f64": r32, "rel_f64_vs_plain": r64}
        smoke.check(r32 <= 1e-3, f"float32 vs float64 plain rel={r32:.3e} (tol 1e-3)")
        smoke.check(r64 <= 1e-10, f"float64 kernels vs plain rel={r64:.3e} (tol 1e-10)")

        y_small = y_np[:N_SMALL]
        lml_k = logpdf(make_fx(torch.float64, N_SMALL, DEVICE), y_small).item()
        lml_seq = logpdf(make_fx(torch.float64, N_SMALL, "cpu"), y_small,
                         engine="sequential").item()
        r_seq = rel(lml_k, lml_seq)
        smoke.record["main_path"]["rel_f64_vs_sequential_20k"] = r_seq
        smoke.check(r_seq <= 1e-9,
                    f"float64 N={N_SMALL} kernels {lml_k!r} vs sequential {lml_seq!r} "
                    f"rel={r_seq:.3e} (tol 1e-9)")

        g_fused = autograd_grad(DEVICE, engine="block", fused=True)
        g_plain = autograd_grad(DEVICE, engine="block", fused=False)
        g_seq = autograd_grad("cpu", engine="sequential")
        r_plain = ((g_fused - g_plain).abs().max() / g_plain.abs().max()).item()
        r_gseq = ((g_fused.cpu() - g_seq).abs().max() / g_seq.abs().max()).item()
        print(f"  grad fused {g_fused.tolist()}, sequential {g_seq.tolist()}")
        smoke.record["main_path"]["grad_rel_vs_plain"] = r_plain
        smoke.record["main_path"]["grad_rel_vs_sequential"] = r_gseq
        smoke.check(r_plain <= 1e-10, f"grad fused vs plain rel={r_plain:.3e} (tol 1e-10)")
        smoke.check(r_gseq <= 1e-6, f"grad fused vs sequential rel={r_gseq:.3e} (tol 1e-6)")

        for name, dtype in dtypes.items():
            fx_p, y_p = make_fx(dtype, N_MAIN, DEVICE), y_dev[name]
            summary = call_profile(lambda: logpdf(fx_p, y_p), VALUE_KERNELS)
            smoke.record.setdefault("profile_logpdf", {})[name] = summary
            print(f"  logpdf profile {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K1-K3 on the device")

    def autograd_grad(device, **kw):
        """Reverse-mode gradient of the float64 lml at N = 20k."""
        p = p0.detach().to(device).requires_grad_()
        s2, sc, noise = torch.exp(p)
        fx_g = make_fx(torch.float64, N_SMALL, device, s2=s2, sc=sc, noise=noise)
        (g,) = torch.autograd.grad(logpdf(fx_g, y_np[:N_SMALL], **kw), p)
        return g

    # ---- 6. training path ------------------------------------------------
    def phase_training():
        rec = smoke.record["training"] = {}
        vg32 = value_and_grad_fwd_lgssm(make_model_fn(torch.float32, N_MAIN, DEVICE), y_np)
        kernels.reset_launch_counts()
        v32, g32 = vg32(p0)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record["launches"].update({name: counts[name] for name in JVP_KERNELS})
        print(f"  float32 N={N_MAIN} value {v32.item()!r} grad {g32.tolist()}, launches {counts}")
        smoke.check(all(counts[name] >= 1 for name in JVP_KERNELS),
                    "K4-K6 launched on the training path")
        smoke.check(v32.shape == () and g32.shape == (k,)
                    and bool(torch.isfinite(g32).all()) and math.isfinite(v32.item()),
                    "float32 value and gradient finite, shapes () and (k,)")

        v64, g64 = value_and_grad_fwd_lgssm(
            make_model_fn(torch.float64, N_MAIN, DEVICE), y_np)(p0)
        lml64 = logpdf(make_fx(torch.float64, N_MAIN, DEVICE), y_dev["float64"]).item()
        print(f"  float64 N={N_MAIN} value {v64.item()!r} grad {g64.tolist()}")
        r_v32 = rel(v32.item(), v64.item())
        r_v64 = rel(v64.item(), lml64)
        # Each component is a sum over the same N steps, so float32 rounding
        # scales with the largest one: the floor is 1e-6 of it, the gate
        # 1e-3 of the component itself.
        floor = 1e-6 * g64.abs().max().item()
        excess = ((g32 - g64).abs() - (1e-3 * g64.abs() + floor)).max().item()
        rec.update({"value_f32": v32.item(), "value_f64": v64.item(), "grad_f32": g32.tolist(),
                    "grad_f64": g64.tolist(), "rel_value_f32_vs_f64": r_v32,
                    "rel_value_f64_vs_logpdf": r_v64,
                    "grad_f32_abs_err": (g32 - g64).abs().tolist(),
                    "grad_f32_rel_per_component": ((g32 - g64).abs() / g64.abs()).tolist(),
                    "grad_floor": floor,
                    "grad_floor_over_smallest": floor / g64.abs().min().item()})
        smoke.check(r_v32 <= 1e-3, f"float32 value vs float64 rel={r_v32:.3e} (tol 1e-3)")
        smoke.check(r_v64 <= 1e-10, f"float64 value vs logpdf on K1-K3 rel={r_v64:.3e} (tol 1e-10)")
        smoke.check(excess <= 0.0,
                    f"float32 grad vs float64: |g64|={g64.abs().tolist()} "
                    f"abs err={rec['grad_f32_abs_err']} "
                    f"rel={rec['grad_f32_rel_per_component']} (tol 1e-3 relative + {floor:.3g} "
                    f"absolute, {rec['grad_floor_over_smallest']:.2e} of the smallest component)")

        # A model K4-K6 do not take (irregular times) is refused on the card.
        times = torch.linspace(0.0, 4.0, 64, dtype=torch.float64, device=DEVICE) ** 1.5

        def irregular_fn(p):
            s2, sc, noise = torch.exp(p)
            kern = (s2 * Matern52()).stretch(sc)
            return build_lgssm(to_sde(GP(kern), device=DEVICE)(times, noise))

        before = kernels.launch_counts()
        try:
            value_and_grad_fwd_lgssm(irregular_fn, y_np[:64])(p0)
            refused = False
        except NotImplementedError as e:
            refused = "item 4b" in str(e)
        smoke.check(refused and kernels.launch_counts() == before,
                    "a model the kernels do not take raises on the card (no plain schedule runs)")

        y_small = y_np[:N_SMALL]
        _, g_k = value_and_grad_fwd_lgssm(make_model_fn(torch.float64, N_SMALL, DEVICE), y_small)(p0)
        _, g_p = value_and_grad_fwd_lgssm(
            make_model_fn(torch.float64, N_SMALL, "cpu"), y_small)(p0.cpu())
        g_seq = autograd_grad("cpu", engine="sequential")
        r_p = ((g_k.cpu() - g_p).abs().max() / g_p.abs().max()).item()
        r_s = ((g_k.cpu() - g_seq).abs().max() / g_seq.abs().max()).item()
        rec.update({"grad_20k_rel_vs_plain_jvp": r_p, "grad_20k_rel_vs_sequential": r_s})
        smoke.check(r_p <= 1e-8,
                    f"float64 N={N_SMALL} grad vs plain forward-mode schedule rel={r_p:.3e} (tol 1e-8)")
        smoke.check(r_s <= 1e-6,
                    f"float64 N={N_SMALL} grad vs sequential autograd rel={r_s:.3e} (tol 1e-6)")

        p = p0.clone()
        opt = torch.optim.Adam([p], lr=1e-1)
        losses = []
        for _ in range(3):
            value, grad = vg32(p)
            p.grad = -grad
            opt.step()
            losses.append(-value.item())
        print(f"  three Adam steps at N={N_MAIN} float32: losses {losses}, p {p.tolist()}")
        rec["adam_losses"] = losses
        smoke.check(all(math.isfinite(x) for x in losses) and losses[0] > losses[1] > losses[2],
                    "three Adam steps: finite, decreasing loss")

        vg_small = value_and_grad_fwd_lgssm(make_model_fn(torch.float64, N_SMALL, DEVICE), y_small)

        def neg_vg(params):
            value, grad = vg_small(params)
            return -value, -grad

        def objective(params):
            s2, sc, noise = torch.exp(params)
            return -logpdf(make_fx(torch.float64, N_SMALL, DEVICE, s2=s2, sc=sc, noise=noise),
                           y_small)

        fit_fwd = fit(neg_vg, p0, steps=3, has_grad=True)
        fit_rev = fit(objective, p0, steps=3)
        r_fit = ((fit_fwd.losses - fit_rev.losses).abs() / fit_rev.losses.abs()).max().item()
        print(f"  fit at N={N_SMALL} float64: losses {fit_fwd.losses.tolist()}, "
              f"params {fit_fwd.params.tolist()}")
        rec.update({"fit_losses": fit_fwd.losses.tolist(), "fit_rel_fwd_vs_autograd": r_fit})
        smoke.check(bool((fit_fwd.losses[1:] < fit_fwd.losses[:-1]).all()) and r_fit <= 1e-8,
                    f"fit on vg decreases and matches fit on autograd rel={r_fit:.3e} (tol 1e-8)")

    # ---- 7. timing -------------------------------------------------------
    def phase_timing():
        for name, dtype in dtypes.items():
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            _, _, rows, priors = jvp_inputs(name)
            L, B = y_main.shape
            comps = kernels.phase1_aggregate(y_main, s_main, packed, D)
            starts = kernels.phase2_starts(comps, m0, P0, D)
            jcomps = kernels.phase1_jvp(y_main, s_main, rows, D, k)
            jstarts = kernels.phase2_jvp_starts(jcomps, priors, D, k)
            fx = make_fx(dtype, N_MAIN, DEVICE)
            vg = value_and_grad_fwd_lgssm(make_model_fn(dtype, N_MAIN, DEVICE), y_dev[name])
            calls = {
                "phase1_aggregate": (
                    lambda: kernels.phase1_aggregate(y_main, s_main, packed, D),
                    lambda: kernels.phase1_aggregate_plain(
                        y_main, s_main, packed, D, chunks=kernels.PHASE1_AGGREGATE_CHUNKS)),
                "phase2_starts": (
                    lambda: kernels.phase2_starts(comps, m0, P0, D),
                    lambda: kernels.phase2_starts_plain(comps, m0, P0, D)),
                "phase3_lml": (
                    lambda: kernels.phase3_lml(y_main, s_main, packed, starts, D),
                    lambda: kernels.phase3_lml_plain(y_main, s_main, packed, starts, D)),
                "phase1_jvp": (
                    lambda: kernels.phase1_jvp(y_main, s_main, rows, D, k),
                    lambda: kernels.phase1_jvp_plain(y_main, s_main, rows, D, k,
                                                     chunks=kernels.PHASE1_JVP_CHUNKS)),
                "phase2_jvp_starts": (
                    lambda: kernels.phase2_jvp_starts(jcomps, priors, D, k),
                    lambda: kernels.phase2_jvp_starts_plain(jcomps, priors, D, k)),
                "phase3_jvp_lml": (
                    lambda: kernels.phase3_jvp_lml(y_main, s_main, rows, jstarts, D, k),
                    lambda: kernels.phase3_jvp_lml_plain(y_main, s_main, rows, jstarts, D, k)),
                "end_to_end_logpdf": (
                    lambda: logpdf(fx, y_dev[name]),
                    lambda: logpdf(fx, y_dev[name], engine="block", fused=False)),
                "end_to_end_value_and_grad": (lambda: vg(p0), None),
            }
            time_calls(name, calls, L, B)

    def time_calls(name, calls, L, B):
        """Median of 5 batches of 10 calls of each kernel call, one call of
        its plain version, and the kernel's bound at (L, B)."""
        for kname, (kernel_call, plain_call) in calls.items():
            with torch.no_grad():
                k_ms = events_ms(kernel_call, reps=10, batches=5)
                # The plain versions ran in the compare phases: one call, no warm-up.
                p_ms = (events_ms(plain_call, reps=1, batches=1, warm_up=False)
                        if plain_call else (None,))
            entry = smoke.record.setdefault(kname, {}).setdefault(name, {})
            entry.update({"ms": k_ms[0], "ms_range": k_ms[1:], "plain_ms": p_ms[0]})
            line = f"  {name} {kname}: {k_ms[0]!r} ms (range {k_ms[1]!r}..{k_ms[2]!r})"
            if plain_call:
                line += f", plain {p_ms[0]!r} ms (one call)"
            if kname in REPLACES:
                bound_ms, bound_by = kernel_bound(kname, name, L, B, D, k)
                entry.update({"bound_ms": bound_ms, "bound_by": bound_by})
                line += f", bound {bound_ms!r} ms by {bound_by}"
            print(line, flush=True)

    # ---- 8. where the time of one vg(p0) call goes -----------------------
    def device_profile(call, calls):
        """({kernel name: device us per call}, device kernels launched) of
        `calls` calls under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        device_us = {}
        n_device_ops = 0
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            is_kernel = "Kernel" in str(getattr(event, "device_type", "")) or \
                str(getattr(event, "device_type", "")).endswith("CUDA")
            if us and is_kernel:
                device_us[event.key] = us / calls
                n_device_ops += event.count
        return device_us, n_device_ops

    def kernel_us(device_us, short):
        """Device us of the kernel `<short>_kernel`, mangled or not: its name
        must not run on from a longer one (phase3_states_kernel within
        affine_phase3_states_kernel)."""
        pattern = re.compile(rf"(?<![A-Za-z_]){short}_kernel")
        return sum(us for key, us in device_us.items() if pattern.search(key))

    def call_profile(call, shorts, calls=10):
        """One call's ms (CUDA events, median of 3 batches of `calls`), and
        under torch.profiler over `calls` calls: device busy us, idle share,
        the us of the kernels `shorts` and of the rest, device ops a call."""
        call_ms = events_ms(call, reps=calls, batches=3)[0]
        device_us, n_device_ops = device_profile(call, calls)
        busy_us = sum(device_us.values())
        ours = {short: kernel_us(device_us, short) for short in shorts}
        return {"call_ms": call_ms, "device_busy_us": busy_us,
                "idle_share": 1.0 - busy_us / (1e3 * call_ms) if busy_us else None,
                "kernel_us": ours, "other_device_us": busy_us - sum(ours.values()),
                "device_ops_per_call": n_device_ops / calls}

    def stage_ms(fn, reps=20):
        """Median host-clock ms of fn() between two synchronises, and its output."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    def phase_profile():
        for name, dtype in dtypes.items():
            model_fn = make_model_fn(dtype, N_MAIN, DEVICE)
            vg = value_and_grad_fwd_lgssm(model_fn, y_dev[name])
            summary = call_profile(lambda: vg(p0), JVP_KERNELS)
            build_ms, _ = stage_ms(lambda: model_fn(p0))
            tangents_ms, (model, tangents) = stage_ms(
                lambda: learning._model_and_tangents(model_fn, p0))
            fwd_ms, _ = stage_ms(
                lambda: block.logpdf_fwd_grad(model, y_dev[name], tangents))
            rows_ms, _ = stage_ms(lambda: block._tangent_rows(model, tangents))
            summary["host_stage_ms"] = {"model_fn": build_ms, "jacfwd_model_and_tangents": tangents_ms,
                                        "logpdf_fwd_grad": fwd_ms, "of_which_tangent_rows": rows_ms}
            smoke.record.setdefault("profile", {})[name] = summary
            print(f"  {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K4-K6 on the device")


    # ---- 9-12. smoothing and prediction ------------------------------------
    y_c1 = np.random.default_rng(SEED).standard_normal(N_C1)

    def make_c1(dtype, device):
        """The reference's bench config c1: GP(Matern32()), noise 0.1."""
        return to_sde(GP(Matern32()), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, N_C1), NOISE)

    def posterior_marginals(fx, y):
        """The public call: the posterior's marginals at the training inputs
        with prediction noise 0.1."""
        return gpost.marginals(gpost.posterior(fx, y)(fx.x, NOISE))

    def affine_inputs(name):
        """The affine rows, initial mean and covariance that the N = 1M
        posterior's marginals hand K8-K10 (the reverse iteration view)."""
        post = posterior_with_missings(build_lgssm(make_fx(dtypes[name], N_MAIN, DEVICE)),
                                       y_dev[name])
        params = block._affine_comps_iteration(post, block._pallas_blocks(N_MAIN))
        return params, post.trans.x0.mean, symmetrize(post.trans.x0.cov)

    def rel_max(a, b):
        """Largest error relative to the largest entry of the reference b
        (0 where both are all zeros, as the prior's means are)."""
        scale = b.abs().max().clamp_min(torch.finfo(torch.float64).tiny)
        return ((a - b).abs().max() / scale).item()

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def ragged_affine(name, L, B):
        """Time-varying stable maps (KT, L, B), an initial state, on the card."""
        rng = np.random.default_rng(SEED + L)
        F = np.eye(D) * 0.95 + 0.02 * rng.standard_normal((L, B, D, D))
        G = 0.1 * rng.standard_normal((L, B, D, D))
        C = np.einsum("lbij,lbkj->lbik", G, G)
        rows = np.concatenate([F.reshape(L, B, D * D), 0.1 * rng.standard_normal((L, B, D)),
                               C.reshape(L, B, D * D)], axis=-1)
        to = lambda x: torch.as_tensor(x, dtype=dtypes[name], device=DEVICE).contiguous()
        return to(rows.transpose(2, 0, 1)), to(0.1 * rng.standard_normal(D)), to(np.eye(D))

    # ---- 9. state-emitting kernels against their plain versions ---------
    def phase_compare_states():
        SD = D + D * D
        rows = lambda t: t.reshape(SD, -1)
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            starts = kernels.phase2_starts(
                kernels.phase1_aggregate(y_main, s_main, packed, D), m0, P0, D)
            params, am0, aP0 = affine_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D}, affine rows {tuple(params.shape)}")
            p7 = kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                             chunks=kernels.PHASE3_STATES_CHUNKS)
            p8 = kernels.affine_phase1_plain(params, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
            p9 = kernels.affine_phase2_starts_plain(p8, am0, aP0, D)
            p10 = kernels.affine_phase3_states_plain(params, p9, D)
            k7 = kernels.phase3_states(y_main, s_main, packed, starts, D)
            k8 = kernels.affine_phase1(params, D)
            k9 = kernels.affine_phase2_starts(p8, am0, aP0, D)
            k10 = kernels.affine_phase3_states(params, p9, D)
            torch.cuda.synchronize()
            via_k8 = kernels.affine_phase3_states_plain(
                params, kernels.affine_phase2_starts_plain(k8, am0, aP0, D), D)
            via_k9 = kernels.affine_phase3_states_plain(params, k9, D)
            record_comparison("phase3_states", name, k7, p7, rows(k7), rows(p7), "states")
            record_comparison("affine_phase1", name, k8, p8, rows(via_k8), rows(p10), "states")
            record_comparison("affine_phase2_starts", name, k9, p9, rows(via_k9), rows(p10),
                              "states")
            record_comparison("affine_phase3_states", name, k10, p10, rows(k10), rows(p10),
                              "states")
            for shape in RAGGED_SHAPES:
                y_r, s_r = ragged_streams(name, *shape)
                r_starts = kernels.phase2_starts_plain(
                    kernels.phase1_aggregate_plain(y_r, s_r, packed, D,
                                                   chunks=kernels.PHASE1_AGGREGATE_CHUNKS),
                    m0, P0, D)
                p7 = kernels.phase3_states_plain(y_r, s_r, packed, r_starts, D,
                                                 chunks=kernels.PHASE3_STATES_CHUNKS)
                k7 = kernels.phase3_states(y_r, s_r, packed, r_starts, D)
                torch.cuda.synchronize()
                record_comparison("phase3_states", name, k7, p7, rows(k7), rows(p7), "states",
                                  shape=shape)
                r_params, r_m0, r_P0 = ragged_affine(name, *shape)
                p8 = kernels.affine_phase1_plain(r_params, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
                p10 = kernels.affine_phase3_states_plain(
                    r_params, kernels.affine_phase2_starts_plain(p8, r_m0, r_P0, D), D)
                k8 = kernels.affine_phase1(r_params, D)
                torch.cuda.synchronize()
                via_k8 = kernels.affine_phase3_states_plain(
                    r_params, kernels.affine_phase2_starts_plain(k8, r_m0, r_P0, D), D)
                record_comparison("affine_phase1", name, k8, p8, rows(via_k8), rows(p10),
                                  "states", shape=shape)

    # ---- 10. posterior path ----------------------------------------------
    def phase_posterior():
        rec = smoke.record["posterior"] = {}
        # The main path: float32 first, its launch counts are the kernels line's.
        main = {}
        for name in ("float32", "float64"):
            fx = make_fx(dtypes[name], N_MAIN, DEVICE)
            kernels.reset_launch_counts()
            m, v = posterior_marginals(fx, y_dev[name])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if name == "float32":
                smoke.record["launches"].update({kn: counts[kn] for kn in STATE_KERNELS})
            smoke.check(all(counts[kn] >= 1 for kn in POSTERIOR_KERNELS)
                        and counts["phase3_lml"] == 0,
                        f"{name} N={N_MAIN} posterior marginals: K1, K2, K7-K10 launched, "
                        f"K3 not: {counts}")
            smoke.check(m.shape == v.shape == (N_MAIN,) and finite(m, v) and bool((v > 0).all()),
                        f"{name} N={N_MAIN}: finite means, positive variances, shape ({N_MAIN},)")
            main[name] = (m.double(), v.double())
        (m32, v32), (m64, v64) = main["float32"], main["float64"]
        rec["main_f32_vs_f64"] = {
            "means_rel": rel_max(m32, m64), "vars_rel": rel_max(v32, v64),
            "means_abs": (m32 - m64).abs().max().item(), "vars_abs": (v32 - v64).abs().max().item(),
            "max_abs_mean": m64.abs().max().item(), "var_min": v64.min().item(),
            "var_max": v64.max().item()}
        print(f"  N={N_MAIN} D={D} float32 vs float64: {json.dumps(rec['main_f32_vs_f64'])}")

        c1 = {}
        for name in ("float32", "float64"):
            fx = make_c1(dtypes[name], DEVICE)
            kernels.reset_launch_counts()
            m, v = posterior_marginals(fx, y_c1)
            pm, pv = marginals(fx)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            smoke.check(all(counts[kn] >= 1 for kn in POSTERIOR_KERNELS) and finite(m, v, pm, pv),
                        f"c1 {name}: kernels launched {counts}, finite")
            c1[name] = [t.double() for t in (m, v, pm, pv)]
        r_c1 = [rel_max(a, b) for a, b in zip(c1["float32"], c1["float64"])]
        rec["c1_f32_vs_f64_rel"] = dict(zip(("post_means", "post_vars", "prior_means",
                                             "prior_vars"), r_c1))
        smoke.check(max(r_c1) <= 1e-3,
                    f"c1 float32 vs float64 rel {rec['c1_f32_vs_f64_rel']} (tol 1e-3)")

        y_small = y_np[:N_SMALL]
        m_k, v_k = posterior_marginals(make_fx(torch.float64, N_SMALL, DEVICE), y_small)
        m_s, v_s = posterior_marginals(make_fx(torch.float64, N_SMALL, "cpu"), y_small)
        r_seq = max(rel_max(m_k.cpu(), m_s), rel_max(v_k.cpu(), v_s))
        rec["f64_20k_rel_vs_sequential"] = r_seq
        smoke.check(r_seq <= 1e-9,
                    f"float64 N={N_SMALL} card vs sequential engine on the CPU rel={r_seq:.3e} "
                    f"(tol 1e-9)")

        x_pr = np.sort(np.random.default_rng(SEED + 1).uniform(0.0, 1e-3 * N_TRAIN_NEW,
                                                               N_PRED_NEW))

        def new_times(device):
            fx = make_fx(torch.float64, N_TRAIN_NEW, device)
            fp = gpost.posterior(fx, y_np[:N_TRAIN_NEW])
            return gpost.marginals(fp(x_pr, 0.05))

        kernels.reset_launch_counts()
        m_n, v_n = new_times(DEVICE)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        m_c, v_c = new_times("cpu")
        r_new = max(rel_max(m_n.cpu(), m_c), rel_max(v_n.cpu(), v_c))
        rec["new_times_rel_vs_cpu"] = r_new
        smoke.check(all(counts[kn] == 1 for kn in STATE_KERNELS[1:])
                    and counts["phase3_states"] == 0 and m_n.shape == (N_PRED_NEW,),
                    f"new times: sequential filter, then K8-K10: {counts}")
        smoke.check(r_new <= 1e-9,
                    f"float64 new times ({N_TRAIN_NEW} + {N_PRED_NEW}) card vs CPU "
                    f"rel={r_new:.3e} (tol 1e-9)")
        try:
            gpost.cov(gpost.posterior(make_c1(torch.float64, DEVICE), y_c1)(RegularSpacing(0.0, 1e-3, 4)))
            refused = False
        except NotImplementedError:
            refused = True
        smoke.check(refused, "the dense posterior covariance is refused")

    # ---- 11. timing of the posterior path --------------------------------
    def phase_timing_states():
        for name, dtype in dtypes.items():
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            starts = kernels.phase2_starts(
                kernels.phase1_aggregate(y_main, s_main, packed, D), m0, P0, D)
            params, am0, aP0 = affine_inputs(name)
            agg = kernels.affine_phase1(params, D)
            astarts = kernels.affine_phase2_starts(agg, am0, aP0, D)
            fx, fx_c1 = make_fx(dtype, N_MAIN, DEVICE), make_c1(dtype, DEVICE)
            calls = {
                "phase3_states": (
                    lambda: kernels.phase3_states(y_main, s_main, packed, starts, D),
                    lambda: kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                                        chunks=kernels.PHASE3_STATES_CHUNKS)),
                "affine_phase1": (
                    lambda: kernels.affine_phase1(params, D),
                    lambda: kernels.affine_phase1_plain(params, D,
                                                        chunks=kernels.AFFINE_PHASE1_CHUNKS)),
                "affine_phase2_starts": (
                    lambda: kernels.affine_phase2_starts(agg, am0, aP0, D),
                    lambda: kernels.affine_phase2_starts_plain(agg, am0, aP0, D)),
                "affine_phase3_states": (
                    lambda: kernels.affine_phase3_states(params, astarts, D),
                    lambda: kernels.affine_phase3_states_plain(params, astarts, D)),
                "end_to_end_posterior_marginals": (
                    lambda: posterior_marginals(fx, y_dev[name]), None),
                "end_to_end_posterior_marginals_c1": (
                    lambda: posterior_marginals(fx_c1, y_c1), None),
            }
            time_calls(name, calls, L, B)

    # ---- 12. where the time of one posterior-marginals call goes ---------
    def phase_profile_posterior():
        for name, dtype in dtypes.items():
            fx = make_fx(dtype, N_MAIN, DEVICE)
            y = y_dev[name]
            summary = call_profile(lambda: posterior_marginals(fx, y), POSTERIOR_KERNELS)
            B = block._pallas_blocks(N_MAIN)
            build_ms, model = stage_ms(lambda: build_lgssm(fx))
            missing_ms, (model_f, y_f, _) = stage_ms(lambda: transform_model_and_obs(model, y))
            filter_ms, xf = stage_ms(lambda: block._filter_state_comps(model_f, y_f, None, None))
            reversal_ms, post = stage_ms(lambda: block._reversed_model(model_f, xf))
            post = replace_observation_noise_cov(post, fx.noise.value.expand(N_MAIN))
            rows_ms, params = stage_ms(lambda: block._affine_comps_iteration(post, B))
            affine_ms, comps = stage_ms(lambda: block._affine_states(post, params, None))
            project_ms, _ = stage_ms(lambda: block._project(post, comps))
            summary["other_device_ops_per_call"] = (summary["device_ops_per_call"]
                                                    - len(POSTERIOR_KERNELS))
            summary["host_stage_ms"] = {"build_lgssm": build_ms, "missing_data": missing_ms,
                                        "K1_K2_K7_filter_states": filter_ms,
                                        "reversal_of_dynamics": reversal_ms,
                                        "affine_comps_iteration": rows_ms, "K8_K9_K10": affine_ms,
                                        "projection": project_ms}
            smoke.record.setdefault("profile_posterior", {})[name] = summary
            print(f"  {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K1, K2, K7-K10 on the device")

    smoke.phase("1. versions and card", phase_versions)
    smoke.phase("2. build", phase_build)
    smoke.phase("3. value kernels vs plain versions at N=1M", phase_compare)
    smoke.phase("4. forward-mode kernels vs plain versions at N=1M", phase_compare_jvp)
    smoke.phase("5. lml path", phase_main_path)
    smoke.phase("6. training path", phase_training)
    smoke.phase("7. timing at N=1M", phase_timing)
    smoke.phase("8. profile of value_and_grad at N=1M", phase_profile)
    smoke.phase("9. state-emitting kernels vs plain versions at N=1M", phase_compare_states)
    smoke.phase("10. posterior path", phase_posterior)
    smoke.phase("11. timing of the posterior path", phase_timing_states)
    smoke.phase("12. profile of posterior marginals at N=1M", phase_profile_posterior)

    print("== detail", json.dumps(smoke.record, default=str))
    if smoke.failures:
        print("chip_smoke FAILED:", *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    kernels_line = {"kernels": [
        {
            "name": kname,
            "route": "cuda",
            "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": smoke.record["launches"][kname],
            "max_abs_err": smoke.record[kname]["float32"]["max_abs_err"],
            "ms": smoke.record[kname]["float32"]["ms"],
            "plain_ms": smoke.record[kname]["float32"]["plain_ms"],
            "bound_ms": smoke.record[kname]["float32"]["bound_ms"],
            "bound_by": smoke.record[kname]["float32"]["bound_by"],
            # No single PyTorch operator folds Kalman filtering elements or
            # runs the recursion, so there is no library call to time.
            "library_ms": None,
        }
        for kname in REPLACES
    ]}
    print(smoke.record["card"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
