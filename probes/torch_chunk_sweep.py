"""Chunk counts of the port's chunked kernels on one CUDA card: K1
(phase1_aggregate), K4 (phase1_jvp), K7 (phase3_states) and K8
(affine_phase1).

    python3 probes/torch_chunk_sweep.py [--parent DIR] [--only NAME ...]

Builds each variant from a copy of temporalgps_torch/csrc/ with the
kernel's constants rewritten (K1: kPhase1AggregateChunks and
kPhase1AggregateWarps; K4: kPhase1JvpChunks and kPhase1JvpWarps; K7:
kPhase3StatesChunks and kPhase3StatesWarps; K8: kAffineChunks and
kAffinePrefetch), one nvcc per variant, all started together; checks that
every variant gives the default build's output (each row relative to its
largest entry: 1e-10 in float64; in float32 only 1e-2, since the order of
the combines, which the chunk count sets, moves rows of these synthetic
aggregates by about 1e-3); and times each at the main path's shapes (D = 3,
k = 3, B = 2048, L = 489: N = 1M), float32 and float64, on synthetic inputs:
CUDA events, median of 5 batches of 10 calls, the variants in turn, twice
over; then each kernel's device time per call under torch.profiler over 10
calls (which leaves out the host's time between back-to-back launches).
With --parent, DIR/temporalgps_torch/csrc/ (a checkout of an earlier commit)
is built too and timed first and last in each round; its entries take a
chunk count where DIR's temporalgps_torch/ops/kernels.py has the kernel's
constant. --only limits the sweep to the named kernels. Prints the
card's name and power limit, each variant's ptxas registers, spills and
shared memory at D = 3, and one JSON line of the times.
"""

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

L_MAIN, B_MAIN, D, K_TANGENTS = 489, 2048, 3, 3

# Each kernel: its source, the Python constant of its chunk count, the
# kernel's two constants, and its variants (label, {constant: value}); the
# first variant is the default build, the reference of the agreement check.
# K1, K4, K7: chunk count C and warps a thread block W (a cluster holds C / W
# thread blocks; W = 16 caps a thread at 128 registers). K8: C (warps a
# thread block) and the steps loaded ahead (U); C = 32 does not fit, K8's
# hand-over slots being static shared memory (48 KB at most).
SWEEP = {
    "phase1_aggregate": ("block_phases.cu", "PHASE1_AGGREGATE_CHUNKS",
                         ("kPhase1AggregateChunks", "kPhase1AggregateWarps"),
                         [("C16_W8", {}), ("C16_W16", {"kPhase1AggregateWarps": 16}),
                          ("C8_W8", {"kPhase1AggregateChunks": 8}),
                          ("C32_W8", {"kPhase1AggregateChunks": 32}),
                          ("C32_W16", {"kPhase1AggregateChunks": 32,
                                       "kPhase1AggregateWarps": 16})]),
    "phase1_jvp": ("block_phases_jvp.cu", "PHASE1_JVP_CHUNKS",
                   ("kPhase1JvpChunks", "kPhase1JvpWarps"),
                   [("C16_W8", {}), ("C8_W8", {"kPhase1JvpChunks": 8}),
                    ("C32_W8", {"kPhase1JvpChunks": 32}),
                    ("C8_W4", {"kPhase1JvpChunks": 8, "kPhase1JvpWarps": 4}),
                    ("C16_W16", {"kPhase1JvpWarps": 16})]),
    "phase3_states": ("block_states.cu", "PHASE3_STATES_CHUNKS",
                      ("kPhase3StatesChunks", "kPhase3StatesWarps"),
                      [("C16_W8", {}), ("C16_W16", {"kPhase3StatesWarps": 16}),
                       ("C8_W8", {"kPhase3StatesChunks": 8}),
                       ("C32_W8", {"kPhase3StatesChunks": 32}),
                       ("C32_W16", {"kPhase3StatesChunks": 32, "kPhase3StatesWarps": 16})]),
    "affine_phase1": ("block_states.cu", "AFFINE_PHASE1_CHUNKS",
                      ("kAffineChunks", "kAffinePrefetch"),
                      [("C16_U1", {}), ("C16_U2", {"kAffinePrefetch": 2}),
                       ("C16_U3", {"kAffinePrefetch": 3}),
                       ("C8_U1", {"kAffineChunks": 8}),
                       ("C8_U2", {"kAffineChunks": 8, "kAffinePrefetch": 2})]),
}


def rewrite(text, consts):
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"constant {name} not found once in the source")
    return text


def source_constant(text, name):
    """The value of `constexpr int name = value;` in a source, or None."""
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    return int(found.group(1)) if found else None


def build_all(jobs, kernels):
    """jobs: (label, csrc dir, source name, consts) -> {label: (library path, ptxas lines)}."""
    out_dir = Path(tempfile.mkdtemp(prefix="chunk_sweep_", dir=kernels.BUILD_DIR))
    nvcc = kernels._nvcc()
    procs = {}
    for i, (label, csrc, source, consts) in enumerate(jobs):
        work = out_dir / f"v{i}"
        work.mkdir()
        shutil.copy(csrc / "lanes.cuh", work / "lanes.cuh")
        (work / source).write_text(rewrite((csrc / source).read_text(), consts))
        lib = work / "lib.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(work / source)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            print(f"== {label}: nvcc failed, left out:", *err.splitlines()[:3], sep="\n  ")
            continue
        built[label] = (lib, [line.split("ptxas info    :")[-1].strip()
                              for line in (out + err).splitlines()
                              if any(k in line for k in ("Compiling entry", "registers", "spill",
                                                         "smem"))])
    return out_dir, built


def profiled_ms(call, kname, calls=10):
    """Device ms per call of the kernel `<kname>_kernel` (not a longer
    kernel name ending so) over `calls` calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    pattern = re.compile(rf"(?<![A-Za-z_]){kname}_kernel")
    us = sum(getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
             for event in prof.key_averages() if pattern.search(event.key))
    return us / calls / 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of an earlier commit to time beside")
    parser.add_argument("--only", nargs="+", choices=sorted(SWEEP), default=sorted(SWEEP),
                        help="the kernels to sweep (default: all four)")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_chunk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from temporalgps_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    csrc = kernels.CSRC_DIR
    jobs, chunk_arg = [], {}
    for kname in args.only:
        source, py_const, (c_const, _), variants = SWEEP[kname]
        if args.parent:
            label = f"{kname} parent"
            parent_csrc = args.parent / "temporalgps_torch" / "csrc"
            jobs.append((label, parent_csrc, source, {}))
            parent_py = (args.parent / "temporalgps_torch" / "ops" / "kernels.py").read_text()
            takes_chunks = re.search(rf"^{py_const} = \d+", parent_py, re.M) is not None
            chunk_arg[label] = (source_constant((parent_csrc / source).read_text(), c_const)
                                if takes_chunks else None)
        for label, consts in variants:
            jobs.append((f"{kname} {label}", csrc, source, consts))
            chunk_arg[f"{kname} {label}"] = consts.get(c_const, getattr(kernels, py_const))
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    out_dir, built = build_all(jobs, kernels)
    for label, (_, log) in built.items():
        wanted = f"{label.split()[0]}_kernel"
        keep, lines = False, []
        for line in log:
            if "Compiling entry" in line:  # the D = 3 instances, not a longer kernel name
                keep = re.search(rf"(?<![A-Za-z_]){wanted}", line) is not None and "Li3E" in line
            if keep:
                lines.append(line)
        print(f"== {label}: ptxas (D = 3)", *lines, sep="\n  ")

    rng = np.random.default_rng(0)
    dev = "cuda"
    results, failed = {}, False
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        to = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
        L, B, k = L_MAIN, B_MAIN, K_TANGENTS
        y = to(rng.standard_normal((L, B)))
        s_np = np.full((L, B), 0.1)
        s_np[60, 1000] = 1e15
        s_np[-2:, -1] = 1e15
        s = to(s_np)
        sym = lambda X: 0.5 * (X + X.T)
        A = np.eye(D) * 0.99 + 0.005 * rng.standard_normal((D, D))
        packed = kernels.pack_params(to(A), to(np.zeros(D)), to(0.01 * np.eye(D)),
                                     to(np.ones(D)), to(0.0), dtype)
        rows = torch.stack([
            kernels.pack_params_s(to(A), to(np.zeros(D)), to(0.01 * np.eye(D)), to(np.ones(D)),
                                  to(0.0), to(0.0), dtype),
            *(kernels.pack_params_s(to(0.1 * rng.standard_normal((D, D))),
                                    to(0.1 * rng.standard_normal(D)),
                                    to(0.01 * sym(rng.standard_normal((D, D)))),
                                    to(0.1 * rng.standard_normal(D)),
                                    to(0.1 * rng.standard_normal()),
                                    to(0.1 * rng.standard_normal()), dtype)
              for _ in range(k))])
        starts = kernels.phase2_starts_plain(
            kernels.phase1_aggregate_plain(y, s, packed, D, chunks=kernels.PHASE1_AGGREGATE_CHUNKS),
            to(np.zeros(D)), to(np.eye(D)), D)
        F = np.eye(D) * 0.999 + 0.001 * rng.standard_normal((L, B, D, D))
        G = 0.01 * rng.standard_normal((L, B, D, D))
        Cn = np.einsum("lbij,lbkj->lbik", G, G)
        params = to(np.concatenate([F.reshape(L, B, D * D), 0.01 * rng.standard_normal((L, B, D)),
                                    Cn.reshape(L, B, D * D)], axis=-1).transpose(2, 0, 1))
        empty = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
        # kernel: (pointers with the output last, ints before the chunk count)
        calls_of = {
            "phase1_aggregate": lambda: ([y, s, packed, empty(kernels.elem_rows(D), B)], [L, B, D]),
            "phase1_jvp": lambda: ([y, s, rows, empty((1 + k) * kernels.elem_rows(D), B)],
                                   [L, B, D, k]),
            "phase3_states": lambda: ([y, s, packed, starts, empty(kernels.state_rows(D), L, B)],
                                      [L, B, D]),
            "affine_phase1": lambda: ([params, empty(kernels.affine_rows(D), B)], [L, B, D]),
        }
        stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        calls, outs = {}, {}
        for label, (lib_path, _) in built.items():
            kname = label.split()[0]
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, f"tgps_{kname}_{suffix}")
            ptrs, ints = calls_of[kname]()
            if chunk_arg[label] is not None:
                ints = ints + [chunk_arg[label]]
            fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, ptrs=ptrs, ints=ints, label=label):
                err = fn(*[t.data_ptr() for t in ptrs], *ints, stream())
                if err:
                    raise RuntimeError(f"{label}: launch failed with CUDA error {err}")

            call()
            torch.cuda.synchronize()
            out = ptrs[-1]
            calls[label], outs[label] = call, out.reshape(out.shape[0], -1).clone()

        tol = 1e-10 if dtype == torch.float64 else 1e-2
        for label, out in outs.items():
            kname = label.split()[0]
            ref = outs[f"{kname} {SWEEP[kname][3][0][0]}"]
            scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            r = ((out - ref).abs() / scale).max().item()
            ok = bool(torch.isfinite(out).all()) and r <= tol
            print(f"  {suffix} {label}: rel to the default build {r:.3e} ({'ok' if ok else 'FAIL'})")
            failed = failed or not ok

        times = {label: [] for label in calls}
        order = list(calls)
        if args.parent:  # parent, variants, parent: both ends of each kernel's round
            order = order + [lbl for lbl in order if lbl.endswith("parent")]
        for _ in range(2):
            for label in order:
                fn = calls[label]
                fn()
                torch.cuda.synchronize()
                batch = []
                for _ in range(5):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(10):
                        fn()
                    end.record()
                    end.synchronize()
                    batch.append(start.elapsed_time(end) / 10)
                times[label].append(statistics.median(batch))
        for label, ts in times.items():
            device_ms = profiled_ms(calls[label], label.split()[0])
            results[f"{suffix} {label}"] = {"events_ms": ts, "profiler_ms": device_ms}
            print(f"  {suffix} {label}: {' '.join(repr(t) for t in ts)} ms, "
                  f"profiler {device_ms!r} ms")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"card": card, "L": L_MAIN, "B": B_MAIN, "D": D, "k": K_TANGENTS,
                      "ms": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
