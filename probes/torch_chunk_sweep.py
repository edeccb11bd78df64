"""Chunk counts of the port's K4 (phase1_jvp) and K8 (affine_phase1) on one
CUDA card.

    python3 probes/torch_chunk_sweep.py [--parent DIR]

Builds each variant from a copy of temporalgps_torch/csrc/ with K4's
kPhase1JvpChunks and kPhase1JvpWarps, or K8's kAffineChunks and
kAffinePrefetch, rewritten (one nvcc per variant, all started together);
checks that every variant gives the default build's aggregates (each row
relative to its largest entry: 1e-10 in float64; in float32 only 1e-2,
since the order of the combines, which the chunk count sets, moves rows of
these synthetic aggregates by about 1e-3); and times each at the
main path's shapes (D = 3, k = 3, B = 2048, L = 489: N = 1M), float32 and
float64, on synthetic inputs: CUDA events, median of 5 batches of 10
calls, the variants in turn, twice over. With --parent, DIR/temporalgps_torch/csrc/ (a checkout of an earlier
commit, whose K4 and K8 entries take no chunk count) is built too and timed
first and last in each round. Prints the card's name and power limit, each
variant's ptxas registers, spills and shared memory at D = 3, and one JSON
line of the times.
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

# (label, {constant: value}); the first of each kernel is the default build,
# the reference of the agreement check.
# K4: chunk count C and warps a thread block W (a cluster holds C / W thread
# blocks; W = 16 caps a thread at 128 registers). K8: C (warps a thread
# block) and the steps loaded ahead (U); C = 32 does not fit, K8's hand-over
# slots being static shared memory (48 KB at most).
K4_VARIANTS = [("C16_W8", {}), ("C8_W8", {"kPhase1JvpChunks": 8}),
               ("C32_W8", {"kPhase1JvpChunks": 32}),
               ("C8_W4", {"kPhase1JvpChunks": 8, "kPhase1JvpWarps": 4}),
               ("C16_W16", {"kPhase1JvpWarps": 16})]
K8_VARIANTS = [("C16_U1", {}),
               ("C16_U2", {"kAffineChunks": 16, "kAffinePrefetch": 2}),
               ("C16_U3", {"kAffineChunks": 16, "kAffinePrefetch": 3}),
               ("C8_U1", {"kAffineChunks": 8, "kAffinePrefetch": 1}),
               ("C8_U2", {"kAffineChunks": 8, "kAffinePrefetch": 2})]
SOURCE = {"phase1_jvp": "block_phases_jvp.cu", "affine_phase1": "block_states.cu"}


def rewrite(text, consts):
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"constant {name} not found once in the source")
    return text


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of an earlier commit to time beside")
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
    jobs = []
    for kname, variants in (("phase1_jvp", K4_VARIANTS), ("affine_phase1", K8_VARIANTS)):
        if args.parent:
            jobs.append((f"{kname} parent", args.parent / "temporalgps_torch" / "csrc",
                         SOURCE[kname], {}))
        jobs += [(f"{kname} {label}", csrc, SOURCE[kname], consts) for label, consts in variants]
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    out_dir, built = build_all(jobs, kernels)
    for label, (_, log) in built.items():
        wanted = "phase1_jvp_kernel" if label.startswith("phase1_jvp") else "affine_phase1_kernel"
        keep, lines = False, []
        for line in log:
            if "Compiling entry" in line:
                keep = wanted in line and "Li3E" in line  # the D = 3 instances
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
        F = np.eye(D) * 0.999 + 0.001 * rng.standard_normal((L, B, D, D))
        G = 0.01 * rng.standard_normal((L, B, D, D))
        Cn = np.einsum("lbij,lbkj->lbik", G, G)
        params = to(np.concatenate([F.reshape(L, B, D * D), 0.01 * rng.standard_normal((L, B, D)),
                                    Cn.reshape(L, B, D * D)], axis=-1).transpose(2, 0, 1))
        stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        calls, outs = {}, {}
        for label, (lib_path, _) in built.items():
            lib = ctypes.CDLL(str(lib_path))
            chunks = None if label.endswith("parent") else (
                dict(K4_VARIANTS) | dict(K8_VARIANTS))[label.split(" ", 1)[1]]
            if label.startswith("phase1_jvp"):
                fn = getattr(lib, f"tgps_phase1_jvp_{suffix}")
                out = torch.empty(((1 + k) * kernels.elem_rows(D), B), dtype=dtype, device=dev)
                ints = [L, B, D, k] + ([] if chunks is None else [
                    chunks.get("kPhase1JvpChunks", kernels.PHASE1_JVP_CHUNKS)])
                ptrs = [y, s, rows, out]
            else:
                fn = getattr(lib, f"tgps_affine_phase1_{suffix}")
                out = torch.empty((kernels.affine_rows(D), B), dtype=dtype, device=dev)
                ints = [L, B, D] + ([] if chunks is None else [
                    chunks.get("kAffineChunks", kernels.AFFINE_PHASE1_CHUNKS)])
                ptrs = [params, out]
            fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, ptrs=ptrs, ints=ints, label=label):
                err = fn(*[t.data_ptr() for t in ptrs], *ints, stream())
                if err:
                    raise RuntimeError(f"{label}: launch failed with CUDA error {err}")

            call()
            torch.cuda.synchronize()
            calls[label], outs[label] = call, out.clone()

        tol = 1e-10 if dtype == torch.float64 else 1e-2
        for label, out in outs.items():
            ref = outs[next(lbl for lbl in outs if lbl.split()[0] == label.split()[0]
                            and not lbl.endswith("parent"))]
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
            results[f"{suffix} {label}"] = ts
            print(f"  {suffix} {label}: {' '.join(repr(t) for t in ts)} ms")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"card": card, "L": L_MAIN, "B": B_MAIN, "D": D, "k": K_TANGENTS,
                      "ms": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
