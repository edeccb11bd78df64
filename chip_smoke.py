"""Smoke run of the PyTorch port (temporalgps_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final result line:
  1. torch / CUDA versions, and the card's name and power limit (nvidia-smi).
  2. Build the hand-written kernels (csrc/, nvcc) and report the build time
     and ptxas register / spill counts.
  3. Each kernel (K1 phase1_aggregate, K2 phase2_starts, K3 phase3_lml)
     against its plain PyTorch version on the card, at the main path's shapes
     (Matern-5/2, D = 3, N = 1M: B = 2048 blocks of L = 489 steps), float64
     and float32. The gate is on the per-block lml partials downstream of the
     kernel: relative 1e-10 in float64, 1e-4 in float32 (the kernel and the
     plain version round and contract to FMA differently).
  4. The main path, through the public entry points:
       to_sde(GP((s2*Matern52()).stretch(sc)), ArrayStorage(float32),
              device="cuda")(RegularSpacing(0, 1e-3, 1_000_000), 0.1) -> logpdf
     with one missing (NaN) observation. Every kernel's launch count must
     move. The float32 lml must be within 1e-3 relative of the float64 plain
     blocked schedule; the float64 kernel path within 1e-10 of it and, at
     N = 20k, within 1e-9 of the port's sequential engine (on the CPU); the
     gradient through the fused autograd.Function must match the plain
     schedule's (1e-10) and the sequential engine's (1e-6).
  5. Time each kernel and the end-to-end logpdf against the plain versions
     with CUDA events, float32 and float64, at N = 1M.

The second line from the end is {"kernels": [...]} with the float32 (main
path) numbers; the last line is {"ok": true, "device": {...}}.
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

N_MAIN = 1_000_000
N_SMALL = 20_000
NAN_AT = 123_456
SEED = 0
S2, SC, NOISE = 1.0, 1.0, 0.1
SOURCE = "temporalgps_torch/csrc/block_phases.cu"
REPLACES = {
    "phase1_aggregate": "temporalgps_tpu/ops/pallas_kernels.py:227",
    "phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:335",
    "phase3_lml": "temporalgps_tpu/ops/pallas_kernels.py:731",
}
KERNEL_RTOL = {"float64": 1e-10, "float32": 1e-4}


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

    from temporalgps_torch import RegularSpacing, logpdf
    from temporalgps_torch.gp import GP, ArrayStorage, Matern52, to_sde
    from temporalgps_torch.gp.lti_sde import build_lgssm
    from temporalgps_torch.models.missings import transform_model_and_obs
    from temporalgps_torch.ops import block, kernels
    from temporalgps_torch.utils.psd import symmetrize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    dtypes = {"float32": torch.float32, "float64": torch.float64}

    y_np = np.random.default_rng(SEED).standard_normal(N_MAIN)
    y_np[NAN_AT] = np.nan
    y_dev = {name: torch.as_tensor(y_np, dtype=dtype, device="cuda")
             for name, dtype in dtypes.items()}

    def make_fx(dtype, N, device, s2=S2, sc=SC, noise=NOISE):
        kern = (s2 * Matern52()).stretch(sc)
        return to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, N), noise)

    def events_ms(fn, reps, batches):
        """Median and range over `batches` of the ms per call, each batch
        `reps` calls between two CUDA events, after one warm-up call."""
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

    # ---- 3. kernels against their plain versions -------------------------
    def main_inputs(name):
        dtype = dtypes[name]
        model = build_lgssm(make_fx(dtype, N_MAIN, "cuda"))
        model, y, _comp = transform_model_and_obs(model, y_dev[name])
        A, a, Q, H, h, s, y, m0, P0 = block._fused_leaves(model, y)
        B = block._pallas_blocks(N_MAIN)
        y_main, s_main, _ = block._blocked_streams(y, s, B)
        packed = kernels.pack_params(A, a, Q, H, h, dtype)
        return y_main, s_main, packed, m0, symmetrize(P0)

    def phase_compare():
        D = 3
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D}")
            p1 = kernels.phase1_aggregate_plain(y_main, s_main, packed, D)
            p2 = kernels.phase2_starts_plain(p1, m0, P0, D)
            p3 = kernels.phase3_lml_plain(y_main, s_main, packed, p2, D)
            k1 = kernels.phase1_aggregate(y_main, s_main, packed, D)
            k2 = kernels.phase2_starts(p1, m0, P0, D)
            k3 = kernels.phase3_lml(y_main, s_main, packed, p2, D)
            torch.cuda.synchronize()
            downstream = {
                "phase1_aggregate": kernels.phase3_lml_plain(
                    y_main, s_main, packed, kernels.phase2_starts_plain(k1, m0, P0, D), D),
                "phase2_starts": kernels.phase3_lml_plain(y_main, s_main, packed, k2, D),
                "phase3_lml": k3,
            }
            direct = {"phase1_aggregate": (k1, p1), "phase2_starts": (k2, p2),
                      "phase3_lml": (k3, p3)}
            scale = p3.abs().max().item()
            for kname, partials in downstream.items():
                k_out, p_out = direct[kname]
                finite = bool(torch.isfinite(k_out).all())
                max_abs = (k_out - p_out).abs().max().item()
                r = (partials - p3).abs().max().item() / scale
                smoke.record.setdefault(kname, {})[name] = {"max_abs_err": max_abs,
                                                            "lml_partials_rel": r}
                smoke.check(finite and r <= KERNEL_RTOL[name],
                            f"{kname} {name}: finite={finite} max_abs_err={max_abs:.3e} "
                            f"lml-partials rel={r:.3e} (tol {KERNEL_RTOL[name]:g})")

    # ---- 4. main path ----------------------------------------------------
    def phase_main_path():
        kernels.reset_launch_counts()
        fx = make_fx(torch.float32, N_MAIN, "cuda")
        lml32 = logpdf(fx, y_dev["float32"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record["launches"] = counts
        print(f"  float32 N={N_MAIN} lml = {lml32.item()!r}, launches {counts}")
        smoke.check(all(c >= 1 for c in counts.values()), "every kernel launched on the main path")
        smoke.check(lml32.shape == () and math.isfinite(lml32.item()), "float32 lml finite scalar")

        fx64 = make_fx(torch.float64, N_MAIN, "cuda")
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
        lml_k = logpdf(make_fx(torch.float64, N_SMALL, "cuda"), y_small).item()
        lml_seq = logpdf(make_fx(torch.float64, N_SMALL, "cpu"), y_small,
                         engine="sequential").item()
        r_seq = rel(lml_k, lml_seq)
        smoke.record["main_path"]["rel_f64_vs_sequential_20k"] = r_seq
        smoke.check(r_seq <= 1e-9,
                    f"float64 N={N_SMALL} kernels {lml_k!r} vs sequential {lml_seq!r} "
                    f"rel={r_seq:.3e} (tol 1e-9)")

        def grad(device, **kw):
            p = torch.tensor([math.log(S2), math.log(SC), math.log(NOISE)],
                             dtype=torch.float64, requires_grad=True)
            s2, sc, noise = torch.exp(p)
            fx_g = make_fx(torch.float64, N_SMALL, device, s2=s2, sc=sc, noise=noise)
            (g,) = torch.autograd.grad(logpdf(fx_g, y_small, **kw), p)
            return g

        g_fused = grad("cuda", engine="block", fused=True)
        g_plain = grad("cuda", engine="block", fused=False)
        g_seq = grad("cpu", engine="sequential")
        r_plain = ((g_fused - g_plain).abs().max() / g_plain.abs().max()).item()
        r_gseq = ((g_fused - g_seq).abs().max() / g_seq.abs().max()).item()
        print(f"  grad fused {g_fused.tolist()}, sequential {g_seq.tolist()}")
        smoke.record["main_path"]["grad_rel_vs_plain"] = r_plain
        smoke.record["main_path"]["grad_rel_vs_sequential"] = r_gseq
        smoke.check(r_plain <= 1e-10, f"grad fused vs plain rel={r_plain:.3e} (tol 1e-10)")
        smoke.check(r_gseq <= 1e-6, f"grad fused vs sequential rel={r_gseq:.3e} (tol 1e-6)")

    # ---- 5. timing -------------------------------------------------------
    def phase_timing():
        D = 3
        for name, dtype in dtypes.items():
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            comps = kernels.phase1_aggregate(y_main, s_main, packed, D)
            starts = kernels.phase2_starts(comps, m0, P0, D)
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
            }
            fx = make_fx(dtype, N_MAIN, "cuda")
            calls["end_to_end_logpdf"] = (
                lambda: logpdf(fx, y_dev[name]),
                lambda: logpdf(fx, y_dev[name], engine="block", fused=False))
            for kname, (kernel_call, plain_call) in calls.items():
                with torch.no_grad():
                    k_ms = events_ms(kernel_call, reps=10, batches=5)
                    p_ms = events_ms(plain_call, reps=1, batches=3)
                smoke.record.setdefault(kname, {}).setdefault(name, {}).update(
                    {"ms": k_ms[0], "plain_ms": p_ms[0]})
                print(f"  {name} {kname}: kernel {k_ms[0]!r} ms (range {k_ms[1]!r}..{k_ms[2]!r}), "
                      f"plain {p_ms[0]!r} ms (range {p_ms[1]!r}..{p_ms[2]!r})", flush=True)

    smoke.phase("1. versions and card", phase_versions)
    smoke.phase("2. build", phase_build)
    smoke.phase("3. kernels vs plain versions at N=1M", phase_compare)
    smoke.phase("4. main path", phase_main_path)
    smoke.phase("5. timing at N=1M", phase_timing)

    print("== detail", json.dumps(smoke.record, default=str))
    if smoke.failures:
        print("chip_smoke FAILED:", *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    kernels_line = {"kernels": [
        {
            "name": kname,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kname],
            "launches": smoke.record["launches"][kname],
            "max_abs_err": smoke.record[kname]["float32"]["max_abs_err"],
            "ms": smoke.record[kname]["float32"]["ms"],
            "plain_ms": smoke.record[kname]["float32"]["plain_ms"],
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
