"""Where the time of the ragged pseudo-point case goes (the case of
examples/approx_space_time_learning.py: 25-50 points at each of Nt times
cumsum(0.01 + U(0, 0.01)), 5 pseudo-inputs, float64).

    python3 probes/torch_c5_ragged.py [--cpu] [--nt NT ...] [--engine E ...] [--out PATH]

For each Nt and engine: the host time of each stage of one `elbo` and its
autograd gradient (build_lgssm, the prior marginals, the lml, the
backward), each closed by a device sync, then torch.profiler over one call
at the smallest Nt: the top operators by host time and by device time.
Prints one JSON line, also written to --out.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch.gp import EQ, GP, Matern52, to_sde  # noqa: E402
from temporalgps_torch.gp.lti_sde import build_lgssm  # noqa: E402
from temporalgps_torch.models import lgssm as tlgssm  # noqa: E402
from temporalgps_torch.models import missings  # noqa: E402
from temporalgps_torch.space_time import Separable, dtcify, elbo, grids, regular_in_time  # noqa: E402


def ragged(nt, device):
    rng = np.random.default_rng(0)
    ts = np.cumsum(0.01 + rng.random(nt) * 0.01)
    counts = rng.integers(25, 51, nt)
    splits = np.split(rng.uniform(-3, 3, counts.sum()), np.cumsum(counts)[:-1])
    x = regular_in_time(ts, [np.sort(v) for v in splits])
    y = torch.as_tensor(rng.standard_normal(len(x)), device=device)
    return x, y, torch.linspace(-3, 3, 5, dtype=torch.float64, device=device)


def stages(nt, engine, device):
    x, y, z = ragged(nt, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        out[name] = 1e3 * (now - t)
        t = now

    p = torch.zeros(3, dtype=torch.float64, device=device, requires_grad=True)
    s2, sc, noise = torch.exp(p)
    fx = to_sde(GP(s2 * Separable(EQ().stretch(sc), Matern52())), device=device)(x, noise)
    mark("setup")
    model = build_lgssm(dtcify(z, fx))
    mark("build_lgssm")
    y_tf = grids.observations_to_time_form(x, y)
    mark("time_form")
    tlgssm.marginals_diag(model, engine=engine)
    mark("marginals_diag")
    lp = missings.logpdf_with_missings(model, y_tf, engine=engine)
    mark("logpdf")
    torch.autograd.grad(lp, p)
    mark("backward")
    p = torch.zeros(3, dtype=torch.float64, device=device, requires_grad=True)
    s2, sc, noise = torch.exp(p)
    fx = to_sde(GP(s2 * Separable(EQ().stretch(sc), Matern52())), device=device)(x, noise)
    torch.autograd.grad(elbo(fx, y, z, engine=engine), p)
    mark("elbo_and_grad")
    return out


def profile(nt, engine, device):
    from torch.profiler import ProfilerActivity, profile as prof

    x, y, z = ragged(nt, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])

    def call():
        p = torch.zeros(3, dtype=torch.float64, device=device, requires_grad=True)
        s2, sc, noise = torch.exp(p)
        fx = to_sde(GP(s2 * Separable(EQ().stretch(sc), Matern52())), device=device)(x, noise)
        torch.autograd.grad(elbo(fx, y, z, engine=engine), p)

    call()
    with prof(activities=acts) as pr:
        call()
        if device == "cuda":
            torch.cuda.synchronize()
    ev = pr.key_averages()
    host = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:12]
    dev = sorted(ev, key=lambda e: -(getattr(e, "self_device_time_total", 0) or 0))[:12]
    return {"host_ms": {e.key[:70]: e.self_cpu_time_total / 1e3 for e in host},
            "host_count": {e.key[:70]: e.count for e in host},
            "device_ms": {e.key[:70]: (getattr(e, "self_device_time_total", 0) or 0) / 1e3
                          for e in dev}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nt", type=int, nargs="+", default=[1000, 10_000, 100_000])
    ap.add_argument("--engine", nargs="+", default=["parallel", "block"])
    ap.add_argument("--out")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    res = {"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "stages_ms": {}, "profile": {}}
    for engine in args.engine:
        for nt in args.nt:
            res["stages_ms"][f"{engine}_{nt}"] = stages(nt, engine, device)
            print(engine, nt, json.dumps(res["stages_ms"][f"{engine}_{nt}"]), flush=True)
        res["profile"][engine] = profile(min(args.nt), engine, device)
        print(engine, json.dumps(res["profile"][engine]), flush=True)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
