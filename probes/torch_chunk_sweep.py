"""Chunk counts and thread-block shapes of the port's chunked kernels on one
CUDA card: K1 (phase1_aggregate), K3 (phase3_lml), K4 (phase1_jvp), K6
(phase3_jvp_lml), K7 (phase3_states), K8 (affine_phase1) and K10
(affine_phase3_states); the cluster and thread-block shapes of the three
scans K2 (phase2_starts), K5 (phase2_jvp_starts) and K9
(affine_phase2_starts); and the steps the streamed forms of K1, K3 and K7
(`<name>_streamed`, per-step transition rows) load ahead.

    python3 probes/torch_chunk_sweep.py [--parent DIR] [--only NAME ...]
    python3 probes/torch_chunk_sweep.py --sass [--only NAME ...]

Builds each variant from a copy of temporalgps_torch/csrc/ with the
kernel's constants rewritten (K1 and K3: kPhase1AggregateChunks and
kPhase1AggregateWarps; K2: kPhase2Cluster, kPhase2Warps and kPhase2Fold;
K4 and K6: kPhase1JvpChunks and kPhase1JvpWarps; K5: kPhase2JvpCluster,
kPhase2JvpWarps, kPhase2JvpFold and kPhase2JvpSharedWarpsF32 / F64; K7:
kPhase3StatesChunks and kPhase3StatesWarps; K8: kAffineChunks and
kAffinePrefetch; K9: kAffineScanCluster, kAffineScanWarps and
kAffineScanFold; K10: kAffinePhase3Warps and kAffinePrefetch; the streamed
forms: kTransPrefetch in lanes.cuh), one nvcc per variant, all started
together; checks that every variant gives the default
build's output (each row relative to its largest entry: 1e-10 in float64;
in float32 only 1e-2, since the order of the combines, which the chunk
count sets, moves rows of these synthetic aggregates by about 1e-3); and
times each at the main path's shapes (D = 3, k = 3, B = 2048, L = 489:
N = 1M), float32 and float64, on synthetic inputs: CUDA events, median of 5
batches of 10 calls, the variants in turn, twice over; then each kernel's
device time per call under torch.profiler over 10 calls (which leaves out
the host's time between back-to-back launches). K3, K6 and K10 are fed run
aggregates and starts from the plain versions (K1's, K4's and K8's runs at
their chunk count); K2, K5 and K9 the plain K1's, K4's and K8's block
aggregates. With --parent, DIR/temporalgps_torch/csrc/ (a checkout of an
earlier commit) is built too and timed first and last in each round; each
build's entries take the pointers and ints that its own
temporalgps_torch/ops/kernels.py lists (K1, K4 and K8 with or without a
run-aggregate output, K3, K6 and K10 with or without the run aggregates
and a chunk count). --only limits the sweep to the named kernels. Prints the
card's name and power limit, each variant's ptxas registers, spills and
shared memory at D = 3, and one JSON line of the times.

--sass times nothing and needs no card: it builds the default kernels,
disassembles them with cuobjdump, and for each named kernel's float and
double instances at D = 3 lists every loop (a backward branch and its
target) with the count of instructions between them, the loop body as laid
out. A kernel bound by instruction issue takes at least (loop instructions
x warp-iterations) / (schedulers x clock).
"""

import argparse
import ctypes
import functools
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

# Each kernel: its source, the Python constant of its chunk count (None for
# the scans, which have none), the kernel's constants (the first the chunk count),
# and its variants
# (label, {constant: value}); the first variant is the default build, the
# reference of the agreement check. K1, K4, K7: chunk count C and warps a
# thread block W (a cluster holds C / W thread blocks; W = 16 caps a thread
# at 128 registers). K8: C (warps a thread block) and the steps loaded
# ahead (U); C = 32 does not fit, K8's hand-over slots being static shared
# memory (48 KB at most). K6 and K10 replay K4's and K8's runs, so their C
# is those kernels' (16 here): K6 varies W as K4, K10 its warps a thread
# block (the warps share nothing) and U. K3 replays K1's runs and varies W
# as K1 (W = 16: one thread block of 16 warps, 128 registers a thread). K2,
# K5, K9: thread blocks of the cluster NB, warps a thread block W, and
# aggregates a lane folds before the scan F (NB W 32 F lanes' worth a round:
# 2048 in one round; the smaller shapes take two or four). K5 also: the
# levels that take the left pair from shuffles ("shfl") or from shared memory
# ("smem"), in both dtypes (the default build: shuffles in float, shared
# memory in double). The streamed forms of K1, K3 and K7 (the same entries
# and kernels, on per-step rows): the steps each loads ahead (U).
_PREFETCH = [("U1", {}), ("U2", {"kTransPrefetch": 2}), ("U3", {"kTransPrefetch": 3})]
SWEEP = {
    "phase1_aggregate_streamed": ("block_phases.cu", "PHASE1_AGGREGATE_CHUNKS",
                                  ("kPhase1AggregateChunks", "kTransPrefetch"), _PREFETCH),
    "phase3_lml_streamed": ("block_phases.cu", "PHASE1_AGGREGATE_CHUNKS",
                            ("kPhase1AggregateChunks", "kTransPrefetch"), _PREFETCH),
    "phase3_states_streamed": ("block_states.cu", "PHASE3_STATES_CHUNKS",
                               ("kPhase3StatesChunks", "kTransPrefetch"), _PREFETCH),
    "phase1_aggregate": ("block_phases.cu", "PHASE1_AGGREGATE_CHUNKS",
                         ("kPhase1AggregateChunks", "kPhase1AggregateWarps"),
                         [("C16_W8", {}), ("C16_W16", {"kPhase1AggregateWarps": 16}),
                          ("C8_W8", {"kPhase1AggregateChunks": 8}),
                          ("C32_W8", {"kPhase1AggregateChunks": 32}),
                          ("C32_W16", {"kPhase1AggregateChunks": 32,
                                       "kPhase1AggregateWarps": 16})]),
    "phase2_starts": ("block_phases.cu", None,
                      ("kPhase2Cluster", "kPhase2Warps", "kPhase2Fold"),
                      [("NB8_W8_F1", {}), ("NB8_W4_F2", {"kPhase2Warps": 4, "kPhase2Fold": 2}),
                       ("NB8_W4_F1", {"kPhase2Warps": 4}),
                       ("NB4_W16_F1", {"kPhase2Cluster": 4, "kPhase2Warps": 16}),
                       ("NB4_W8_F2", {"kPhase2Cluster": 4, "kPhase2Fold": 2}),
                       ("NB1_W8_F8", {"kPhase2Cluster": 1, "kPhase2Fold": 8})]),
    "phase2_jvp_starts": ("block_phases_jvp.cu", None,
                          ("kPhase2JvpCluster", "kPhase2JvpWarps", "kPhase2JvpFold",
                           "kPhase2JvpSharedWarpsF32", "kPhase2JvpSharedWarpsF64"),
                          [("NB8_W8_F1", {})] + [
                              (f"NB{nb}_W{w}_F1_{level}",
                               {"kPhase2JvpCluster": nb, "kPhase2JvpWarps": w,
                                "kPhase2JvpSharedWarpsF32": smem, "kPhase2JvpSharedWarpsF64": smem})
                              for nb in (8, 4) for w in (8, 4)
                              for level, smem in (("shfl", 0), ("smem", 1))]),
    "affine_phase2_starts": ("block_states.cu", None,
                             ("kAffineScanCluster", "kAffineScanWarps", "kAffineScanFold"),
                             [(f"NB{nb}_W{w}_F{f}",
                               {"kAffineScanCluster": nb, "kAffineScanWarps": w,
                                "kAffineScanFold": f})
                              for nb in (8, 4) for w in (8, 4) for f in (1, 2)]),
    "phase3_lml": ("block_phases.cu", "PHASE1_AGGREGATE_CHUNKS",
                   ("kPhase1AggregateChunks", "kPhase1AggregateWarps"),
                   [("C16_W8", {}), ("C16_W16", {"kPhase1AggregateWarps": 16})]),
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
    "phase3_jvp_lml": ("block_phases_jvp.cu", "PHASE1_JVP_CHUNKS",
                       ("kPhase1JvpChunks", "kPhase1JvpWarps"),
                       [("C16_W8", {}), ("C16_W16", {"kPhase1JvpWarps": 16})]),
    "affine_phase3_states": ("block_states.cu", "AFFINE_PHASE1_CHUNKS",
                             ("kAffineChunks", "kAffinePhase3Warps"),
                             [("C16_W8_U1", {}), ("C16_W16_U1", {"kAffinePhase3Warps": 16}),
                              ("C16_W8_U2", {"kAffinePrefetch": 2})]),
}


def rewrite(texts, consts):
    """{file name: text} with each `constexpr int name = value;` of consts
    rewritten in the one file that defines it."""
    texts = dict(texts)
    for name, value in consts.items():
        pattern = rf"constexpr int {name} = \d+;"
        where = [f for f, text in texts.items() if len(re.findall(pattern, text)) == 1]
        if len(where) != 1:
            raise RuntimeError(f"constant {name} not found once in the sources")
        texts[where[0]] = re.sub(pattern, f"constexpr int {name} = {value};", texts[where[0]])
    return texts


def entry_name(kname):
    """The C entry and kernel a sweep name runs: a streamed form runs its
    kernel's."""
    return kname.removesuffix("_streamed")


def source_constant(text, name):
    """The value of `constexpr int name = value;` in a source, or None."""
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    return int(found.group(1)) if found else None


def entry_args(kernels_py, kname):
    """(pointers, ints) of the C entry `kname` as a kernels.py lists them."""
    found = re.search(rf'"{kname}": \((\d+), (\d+)\)', kernels_py)
    return int(found.group(1)), int(found.group(2))


def sass_loops(kernels, names):
    """{"<name> <dtype>": [(first address, branch address, instructions)]}
    of each backward branch in the D = 3 instances of the named kernels."""
    lib = kernels.build()
    cuobjdump = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    listing, name = {}, None  # mangled name -> [(address, instruction)]
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        ins = re.match(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found:
            name = found.group(1)
            listing[name] = []
        elif name and ins:
            listing[name].append((int(ins.group(1), 16), ins.group(2)))
    out = {}
    for kname in names:
        for suffix, dtype in (("f", "float32"), ("d", "float64")):
            pattern = re.compile(rf"(?<![A-Za-z_]){kname}_kernelI{suffix}Li3E")
            for mangled, body in listing.items():
                if not pattern.search(mangled):
                    continue
                loops = []
                for address, text in body:
                    branch = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
                    if branch and int(branch.group(1), 16) < address:
                        start = int(branch.group(1), 16)
                        loops.append((start, address,
                                      sum(1 for a, _ in body if start <= a <= address)))
                out[f"{kname} {dtype}"] = sorted(loops)
    return out


def build_all(jobs, kernels):
    """jobs: (label, csrc dir, source name, consts) -> {label: (library path, ptxas lines)}."""
    out_dir = Path(tempfile.mkdtemp(prefix="chunk_sweep_", dir=kernels.BUILD_DIR))
    nvcc = kernels._nvcc()
    procs = {}
    for i, (label, csrc, source, consts) in enumerate(jobs):
        work = out_dir / f"v{i}"
        work.mkdir()
        files = [source, *(header.name for header in csrc.glob("*.cuh"))]
        for name, text in rewrite({f: (csrc / f).read_text() for f in files}, consts).items():
            (work / name).write_text(text)
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
                        help="the kernels to sweep (default: all ten)")
    parser.add_argument("--sass", action="store_true",
                        help="count the instructions in each kernel's loops instead")
    args = parser.parse_args()

    if args.sass:
        from temporalgps_torch.ops import kernels

        counts = sass_loops(kernels, args.only)
        for label, loops in counts.items():
            print(f"{label}: loops " + ", ".join(f"{hex(a)}..{hex(b)} {n}" for a, b, n in loops))
        print(json.dumps({"D": D, "loops": counts}))
        return 0

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
    own_py = (csrc.parent / "ops" / "kernels.py").read_text()
    jobs, chunk_arg, signature = [], {}, {}
    for kname in args.only:
        source, py_const, (c_const, *_), variants = SWEEP[kname]
        if args.parent:
            label = f"{kname} parent"
            parent_csrc = args.parent / "temporalgps_torch" / "csrc"
            jobs.append((label, parent_csrc, source, {}))
            parent_py = (args.parent / "temporalgps_torch" / "ops" / "kernels.py").read_text()
            signature[label] = entry_args(parent_py, entry_name(kname))
            chunk_arg[label] = source_constant((parent_csrc / source).read_text(), c_const)
        for label, consts in variants:
            jobs.append((f"{kname} {label}", csrc, source, consts))
            signature[f"{kname} {label}"] = entry_args(own_py, entry_name(kname))
            chunk_arg[f"{kname} {label}"] = consts.get(
                c_const, getattr(kernels, py_const) if py_const else None)
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    out_dir, built = build_all(jobs, kernels)
    for label, (_, log) in built.items():
        wanted = f"{entry_name(label.split()[0])}_kernel"
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
        agg, runs = kernels.phase1_aggregate_plain(y, s, packed, D,
                                                   chunks=kernels.PHASE1_AGGREGATE_CHUNKS)
        prior = torch.cat([to(np.zeros(D)), to(np.eye(D)).reshape(-1)])
        starts = kernels.phase2_starts_plain(agg, to(np.zeros(D)), to(np.eye(D)), D)
        priors = torch.stack([torch.cat([to(np.zeros(D)), to(np.eye(D)).reshape(-1)]),
                              *(torch.cat([to(0.1 * rng.standard_normal(D)),
                                           to(0.01 * sym(rng.standard_normal((D, D)))).reshape(-1)])
                                for _ in range(k))])
        jagg, jruns = kernels.phase1_jvp_plain(y, s, rows, D, k, chunks=kernels.PHASE1_JVP_CHUNKS)
        jstarts = kernels.phase2_jvp_starts_plain(jagg, priors, D, k)
        F = np.eye(D) * 0.999 + 0.001 * rng.standard_normal((L, B, D, D))
        G = 0.01 * rng.standard_normal((L, B, D, D))
        Cn = np.einsum("lbij,lbkj->lbik", G, G)
        params = to(np.concatenate([F.reshape(L, B, D * D), 0.01 * rng.standard_normal((L, B, D)),
                                    Cn.reshape(L, B, D * D)], axis=-1).transpose(2, 0, 1))
        aagg, aruns = kernels.affine_phase1_plain(params, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
        astarts = kernels.affine_phase2_starts_plain(aagg, to(np.zeros(D)), to(np.eye(D)), D)
        empty = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
        KJ, KT = (1 + k) * kernels.elem_rows(D), kernels.affine_rows(D)
        # kernel: (n_ptr, C) -> (pointers, ints before the chunk count, the
        # output compared); n_ptr tells a build's entry with run aggregates
        # (C of them) from one without, and K1's, K3's and K7's entries with
        # a transition-row pointer (None: the constant form; the streamed
        # forms take the affine maps below as their rows) from those without.
        trans = lambda n, base, rows_: [rows_] * (n > base)
        calls_of = {
            "phase1_aggregate": lambda n, C, rows_=None: (
                [y, s, packed, *trans(n, 5, rows_), out := empty(kernels.elem_rows(D), B)]
                + [empty(C, kernels.elem_rows(D), B)] * (n >= 5), [L, B, D], out),
            "phase2_starts": lambda n, C: (
                [agg, prior, out := empty(kernels.state_rows(D), B)], [B, D], out),
            "phase3_lml": lambda n, C, rows_=None: (
                [y, s, packed, *trans(n, 6, rows_), starts] + [runs] * (n >= 6)
                + [out := empty(B)], [L, B, D], out),
            "phase1_jvp": lambda n, C: (
                [y, s, rows, out := empty(KJ, B)] + [empty(C, KJ, B)] * (n == 5),
                [L, B, D, k], out),
            "phase2_jvp_starts": lambda n, C: (
                [jagg, priors, out := empty((1 + k) * kernels.state_rows(D), B)], [B, D, k], out),
            "affine_phase2_starts": lambda n, C: (
                [aagg, prior, out := empty(kernels.state_rows(D), B)], [B, D], out),
            "phase3_jvp_lml": lambda n, C: (
                [y, s, rows, jstarts] + [jruns] * (n == 6) + [out := empty(1 + k, B)],
                [L, B, D, k], out),
            "phase3_states": lambda n, C, rows_=None: (
                [y, s, packed, *trans(n, 5, rows_), starts,
                 out := empty(kernels.state_rows(D), L, B)], [L, B, D], out),
            "affine_phase1": lambda n, C: (
                [params, out := empty(KT, B)] + [empty(C, KT, B)] * (n == 3), [L, B, D], out),
            "affine_phase3_states": lambda n, C: (
                [params, astarts] + [aruns] * (n == 4) + [out := empty(kernels.state_rows(D), L, B)],
                [L, B, D], out),
        }
        stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        for name in ("phase1_aggregate", "phase3_lml", "phase3_states"):
            calls_of[f"{name}_streamed"] = functools.partial(calls_of[name], rows_=params)
        calls, outs = {}, {}
        for label, (lib_path, _) in built.items():
            kname = label.split()[0]
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, f"tgps_{entry_name(kname)}_{suffix}")
            n_ptr, n_int = signature[label]
            ptrs, ints, out = calls_of[kname](n_ptr, chunk_arg[label])
            if n_int > len(ints):
                ints = ints + [chunk_arg[label]]
            fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, ptrs=ptrs, ints=ints, label=label):
                err = fn(*[None if t is None else t.data_ptr() for t in ptrs], *ints, stream())
                if err:
                    raise RuntimeError(f"{label}: launch failed with CUDA error {err}")

            call()
            torch.cuda.synchronize()
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
            device_ms = profiled_ms(calls[label], entry_name(label.split()[0]))
            results[f"{suffix} {label}"] = {"events_ms": ts, "profiler_ms": device_ms}
            print(f"  {suffix} {label}: {' '.join(repr(t) for t in ts)} ms, "
                  f"profiler {device_ms!r} ms")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"card": card, "L": L_MAIN, "B": B_MAIN, "D": D, "k": K_TANGENTS,
                      "ms": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
