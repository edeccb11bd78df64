"""The factored space-time engine (engine="kron") against "parallel" on the
card: the numbers behind space_time/kron.py's engine=None rule, where the
materialised engines' float32 posterior and rand raise, and the examples'
full-scale times.

    python3 probes/torch_kron_crossover.py [--batches 5] [--examples] [--out PATH]

The model is chip_smoke.py's c4: Separable(EQ().stretch(0.7), Matern52())
on NS points linspace(-3, 3) x RegularSpacing(0, 0.01, NT), noise 0.1, y
from default_rng(0) with a NaN at 4321 mod NS * NT. Rows:

  - timing: NS in (50, 100, 150, 200, 247) x NT in (100, 1000), float32 and
    float64: logpdf and the posterior marginals at the training inputs on
    "kron" and "parallel"; the median, min and max ms of --batches calls
    after one warm-up call (CUDA events), the peak memory; a call that
    raises (a Cholesky factor, the card's memory) is recorded as such;
  - raises: float32 posterior marginals on "parallel" and "block" and the
    prior rand on "parallel" at NS in (50, 75, 100, 125, 150, 200, 247) x
    NT = 1000: "ok" or the error's type;
  - with --examples, each of temporalgps_torch/examples/ at full scale on
    the card in a process of its own: its return code, its wall-clock
    seconds (process start included) and its last line.

Prints one JSON line, also written to --out.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from temporalgps_torch import RegularSpacing, logpdf, rand  # noqa: E402
from temporalgps_torch.gp import EQ, GP, ArrayStorage, Matern52, to_sde  # noqa: E402
from temporalgps_torch.gp import posterior as gpost  # noqa: E402
from temporalgps_torch.space_time import RectilinearGrid, Separable  # noqa: E402

TIMING_NS, TIMING_NT = (50, 100, 150, 200, 247), (100, 1000)
RAISES_NS, RAISES_NT = (50, 75, 100, 125, 150, 200, 247), 1000
EXAMPLES = ("exact_time_inference", "exact_time_learning", "augmented_inference",
            "exact_space_time_inference", "exact_space_time_learning")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make(dtype, ns, nt):
    x = RectilinearGrid(torch.linspace(-3, 3, ns, dtype=dtype, device="cuda"),
                        RegularSpacing(torch.tensor(0.0, dtype=dtype),
                                       torch.tensor(0.01, dtype=dtype), nt))
    fx = to_sde(GP(Separable(EQ().stretch(0.7), Matern52())), ArrayStorage(dtype))(x, 0.1)
    y = np.random.default_rng(0).standard_normal(ns * nt)
    y[4321 % (ns * nt)] = np.nan
    return fx, torch.as_tensor(y, dtype=dtype, device="cuda")


def post_marginals(fx, y, engine):
    return gpost.marginals(gpost.posterior(fx, y)(fx.x, 0.1), engine=engine)


def timed(call, batches):
    """{"median", "min", "max"} ms of `batches` calls after a warm-up call,
    and the peak memory; or {"raises": the error} where a call raises."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        call()
        times = []
        for _ in range(batches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    except (torch.linalg.LinAlgError, torch.cuda.OutOfMemoryError) as err:
        torch.cuda.empty_cache()
        return {"raises": f"{type(err).__name__}: {str(err)[:120]}"}
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def outcome(call):
    try:
        call()
        torch.cuda.synchronize()
        return "ok"
    except (torch.linalg.LinAlgError, torch.cuda.OutOfMemoryError) as err:
        torch.cuda.empty_cache()
        return type(err).__name__


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--examples", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kron_crossover: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "batches": args.batches, "timing": {}, "raises": {}, "examples": {}}

    for nt in TIMING_NT:
        for ns in TIMING_NS:
            for name, dtype in DTYPES.items():
                fx, y = make(dtype, ns, nt)
                row = out["timing"][f"{ns}x{nt}_{name}"] = {}
                for engine in ("kron", "parallel"):
                    row[f"logpdf_{engine}"] = timed(lambda: logpdf(fx, y, engine=engine),
                                                    args.batches)
                    row[f"posterior_marginals_{engine}"] = timed(
                        lambda: post_marginals(fx, y, engine), args.batches)
                print(f"{ns}x{nt}_{name}: {json.dumps(row)}", file=sys.stderr, flush=True)

    for ns in RAISES_NS:
        fx, y = make(torch.float32, ns, RAISES_NT)
        row = out["raises"][f"{ns}x{RAISES_NT}_float32"] = {
            f"posterior_marginals_{e}": outcome(lambda: post_marginals(fx, y, e))
            for e in ("parallel", "block")}
        row["rand_parallel"] = outcome(
            lambda: rand(torch.Generator(device="cuda").manual_seed(0), fx, engine="parallel"))
        print(f"{ns}x{RAISES_NT}_float32 raises: {json.dumps(row)}", file=sys.stderr, flush=True)

    if args.examples:
        for name in EXAMPLES:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", f"temporalgps_torch.examples.{name}"],
                                  capture_output=True, text=True, cwd=ROOT, timeout=900)
            lines = proc.stdout.strip().splitlines()
            out["examples"][name] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                                     "last_line": lines[-1] if lines else proc.stderr[-300:]}
            print(f"example {name}: {json.dumps(out['examples'][name])}", file=sys.stderr,
                  flush=True)

    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
