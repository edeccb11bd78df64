"""Smoke run of the PyTorch port (temporalgps_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final result line:
  1. torch / CUDA versions, and the card's name and power limit (nvidia-smi).
  2. Build the hand-written kernels (csrc/, one nvcc per source, side by
     side) and report the build time and ptxas register / spill counts.
  3. Each value kernel (K1 phase1_aggregate, K2 phase2_starts, K3 phase3_lml)
     against its plain PyTorch version on the card, at the main path's shapes
     (Matern-5/2, D = 3, N = 1M: B = 2048 blocks of L = 489 steps), float64
     and float32. The gate is on the per-block lml partials downstream of the
     kernel: relative 1e-10 in float64, 1e-4 in float32 (the kernel and the
     plain version round and contract to FMA differently).
  4. Each forward-mode kernel (K4 phase1_jvp, K5 phase2_jvp_starts, K6
     phase3_jvp_lml) against its plain version (PyTorch's forward-mode
     autodiff of the plain loops) at the training path's shapes (the same
     streams, k = 3 tangents). The gate is on the (1+k, B) lml rows
     downstream, each row scaled by its own largest entry, with the same two
     tolerances for the same reason: the kernels' tangents are written out by
     hand and contract to FMA, the plain ones come from autodiff.
  5. The lml path, through the public entry points:
       to_sde(GP((s2*Matern52()).stretch(sc)), ArrayStorage(float32))(
           RegularSpacing(0, 1e-3, 1_000_000), 0.1) -> logpdf
     with one missing (NaN) observation. K1-K3's launch counts must move.
     The float32 lml must be within 1e-3 relative of the float64 plain
     blocked schedule; the float64 kernel path within 1e-10 of it and, at
     N = 20k, within 1e-9 of the port's sequential engine (on the CPU); the
     gradient through the fused autograd.Function must match the plain
     schedule's (1e-10) and the sequential engine's (1e-6).
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

The third line from the end is the card's name and power limit, the second
{"kernels": [...]} with the float32 (main path) numbers, the last
{"ok": true, "device": {...}}.
"""

import json
import math
import os
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
}
REPLACES = {
    "phase1_aggregate": "temporalgps_tpu/ops/pallas_kernels.py:227",
    "phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:335",
    "phase3_lml": "temporalgps_tpu/ops/pallas_kernels.py:731",
    "phase1_jvp": "temporalgps_tpu/ops/pallas_kernels.py:471",
    "phase2_jvp_starts": "temporalgps_tpu/ops/pallas_kernels.py:563",
    "phase3_jvp_lml": "temporalgps_tpu/ops/pallas_kernels.py:641",
}
VALUE_KERNELS = ("phase1_aggregate", "phase2_starts", "phase3_lml")
JVP_KERNELS = ("phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml")
KERNEL_RTOL = {"float64": 1e-10, "float32": 1e-4}

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


def kernel_work(name, L, B, D, k):
    """(operations, values moved) of one call: the primal once and each of
    the k tangents once; every input read once, every output written once."""
    K, SD, PK = 3 * D * D + 2 * D, D + D * D, 2 * D * D + 2 * D + 1
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

    from temporalgps_torch import (RegularSpacing, fit, learning, logpdf,
                                   value_and_grad_fwd_lgssm)
    from temporalgps_torch.gp import GP, ArrayStorage, Matern52, to_sde
    from temporalgps_torch.gp.lti_sde import build_lgssm
    from temporalgps_torch.models.missings import transform_model_and_obs
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
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
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

    def record_comparison(kname, name, k_out, p_out, partials, want):
        """`partials` (downstream of the kernel) against `want`, row by row
        relative to each row's largest entry."""
        finite = bool(torch.isfinite(k_out).all())
        max_abs = (k_out - p_out).abs().max().item()
        scale = want.abs().amax(dim=-1, keepdim=True)
        r = ((partials - want).abs() / scale).max().item()
        smoke.record.setdefault(kname, {})[name] = {"max_abs_err": max_abs,
                                                    "lml_partials_rel": r}
        smoke.check(finite and r <= KERNEL_RTOL[name],
                    f"{kname} {name}: finite={finite} max_abs_err={max_abs:.3e} "
                    f"lml-partials rel={r:.3e} (tol {KERNEL_RTOL[name]:g})")

    def phase_compare():
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            smoke.record["shapes"] = {"L": L, "B": B, "D": D, "k": k}
            print(f"  {name}: L={L} B={B} D={D}")
            p1 = kernels.phase1_aggregate_plain(y_main, s_main, packed, D)
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
            p1 = kernels.phase1_jvp_plain(y_main, s_main, rows, D, k)
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
                    lambda: kernels.phase1_aggregate_plain(y_main, s_main, packed, D)),
                "phase2_starts": (
                    lambda: kernels.phase2_starts(comps, m0, P0, D),
                    lambda: kernels.phase2_starts_plain(comps, m0, P0, D)),
                "phase3_lml": (
                    lambda: kernels.phase3_lml(y_main, s_main, packed, starts, D),
                    lambda: kernels.phase3_lml_plain(y_main, s_main, packed, starts, D)),
                "phase1_jvp": (
                    lambda: kernels.phase1_jvp(y_main, s_main, rows, D, k),
                    lambda: kernels.phase1_jvp_plain(y_main, s_main, rows, D, k)),
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
    def phase_profile():
        from torch.profiler import ProfilerActivity, profile

        calls = 10
        for name, dtype in dtypes.items():
            model_fn = make_model_fn(dtype, N_MAIN, DEVICE)
            vg = value_and_grad_fwd_lgssm(model_fn, y_dev[name])
            call_ms = events_ms(lambda: vg(p0), reps=calls, batches=3)[0]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    vg(p0)
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
            busy_us = sum(device_us.values())
            ours = {short: sum(us for key, us in device_us.items() if f"{short}_kernel" in key)
                    for short in ("phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml")}

            def stage_ms(fn, reps=20):
                fn()
                times = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                return statistics.median(times), out

            build_ms, _ = stage_ms(lambda: model_fn(p0))
            tangents_ms, (model, tangents) = stage_ms(
                lambda: learning._model_and_tangents(model_fn, p0))
            fwd_ms, _ = stage_ms(
                lambda: block.logpdf_fwd_grad(model, y_dev[name], tangents))
            rows_ms, _ = stage_ms(lambda: block._tangent_rows(model, tangents))
            summary = {
                "call_ms": call_ms, "device_busy_us": busy_us,
                "idle_share": 1.0 - busy_us / (1e3 * call_ms) if busy_us else None,
                "kernel_us": ours, "other_device_us": busy_us - sum(ours.values()),
                "device_ops_per_call": n_device_ops / calls,
                "host_stage_ms": {"model_fn": build_ms, "jacfwd_model_and_tangents": tangents_ms,
                                  "logpdf_fwd_grad": fwd_ms, "of_which_tangent_rows": rows_ms},
            }
            smoke.record.setdefault("profile", {})[name] = summary
            print(f"  {name}: {json.dumps(summary)}", flush=True)
            smoke.check(busy_us > 0 and all(us > 0 for us in ours.values()),
                        f"{name}: the profiler saw K4-K6 on the device")

    smoke.phase("1. versions and card", phase_versions)
    smoke.phase("2. build", phase_build)
    smoke.phase("3. value kernels vs plain versions at N=1M", phase_compare)
    smoke.phase("4. forward-mode kernels vs plain versions at N=1M", phase_compare_jvp)
    smoke.phase("5. lml path", phase_main_path)
    smoke.phase("6. training path", phase_training)
    smoke.phase("7. timing at N=1M", phase_timing)
    smoke.phase("8. profile of value_and_grad at N=1M", phase_profile)

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
