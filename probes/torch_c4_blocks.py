"""The matrix path's float32 inverse of I + C J on the card, and c4's block
count: the LU inverse in float32 ("lu") against the inverse formed in
float64 and stored in float32 ("wide"), at D = 3, 5, 6, 30 and 150.

    python3 probes/torch_c4_blocks.py [--cpu] [--blocks B ...] [--out PATH]

Each variant replaces `ops/assoc._minv` for its rows (the program's own
rule is not used here). Rows, float32, each scored against a float64
reading and timed (median of 5 calls after one; CUDA events on the card,
the host clock on the CPU):

  - c4, Separable(EQ().stretch(0.7), Matern52()) on NS points
    linspace(-3, 3) x RegularSpacing(0, 0.01, 1000), noise 0.1, y from
    default_rng(0) with a NaN at 4321: NS = 50 (D = 150) and NS = 10
    (D = 30), "parallel" and "block" (the program's block count, or each of
    --blocks); the lml and the posterior means at the training inputs
    (model level, the pipeline of gp.posterior.marginals) against the
    float32 problem's (its model and data as float32 stores them, widened
    to float64, on the sequential engine), the means relative to the
    largest entry; once, the float32 sequential engine (no inverse);
  - d5, Matern52() + Matern32() on RegularSpacing(0, 1e-3, 100k) (chip_smoke
    phase 17's): posterior marginals through gp.posterior (the block
    engine's matrix path), means against the float64 model's;
  - d6, Matern52() + Matern52().stretch(3) on 100k irregular times (phase
    14's): `logpdf` on the block engine's matrix path against float64's;
  - c2, Matern52() on RegularSpacing(0, 1e-3, 1M): `logpdf` on
    engine="parallel" against float64's.

`--cpu` runs every row on the CPU at a reduced size (one thread). Prints
one JSON line, also written to --out.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch import RegularSpacing  # noqa: E402
from temporalgps_torch.gp import (EQ, GP, ArrayStorage, Matern32, Matern52,  # noqa: E402
                                  build_lgssm, logpdf, to_sde)
from temporalgps_torch.gp import posterior as gpost  # noqa: E402
from temporalgps_torch.models import emissions as em  # noqa: E402
from temporalgps_torch.models import lgssm  # noqa: E402
from temporalgps_torch.models.missings import (replace_observation_noise_cov,  # noqa: E402
                                               transform_model_and_obs)
from temporalgps_torch.ops import assoc  # noqa: E402
from temporalgps_torch.space_time import RectilinearGrid, Separable  # noqa: E402
from temporalgps_torch.utils.fill import is_fill  # noqa: E402


def widened(model):
    """The model with every leaf in float64."""
    wide = lambda leaf: (dataclasses.replace(leaf, value=leaf.value.double()) if is_fill(leaf)
                         else leaf.double())
    t = model.trans
    trans = dataclasses.replace(t, As=wide(t.As), offs=wide(t.offs), Qs=wide(t.Qs),
                                x0=type(t.x0)(t.x0.mean.double(), t.x0.cov.double()))
    return lgssm.LGSSM(trans, em.map_leaves(wide, model.emis))


def minv_lu(C, J):
    """(I + C J)^{-1} by LU in the operands' dtype."""
    return torch.linalg.inv(torch.eye(C.shape[-1], dtype=C.dtype, device=C.device) + C @ J)


def minv_wide(C, J):
    """(I + C J)^{-1} formed in float64, stored in the operands' dtype."""
    eye = torch.eye(C.shape[-1], dtype=torch.float64, device=C.device)
    return torch.linalg.inv(eye + C.double() @ J.double()).to(C.dtype)


VARIANTS = {"lu": minv_lu, "wide": minv_wide}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--blocks", nargs="+", type=int, default=[None])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        torch.set_num_threads(1)
        c4_sizes, nt, n_d5, n_d6, n_c2 = (5, 2), 40, 500, 500, 2000
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        c4_sizes, nt, n_d5, n_d6, n_c2 = (50, 10), 1000, 100_000, 100_000, 1_000_000

    def ms(call):
        call()
        times = []
        for _ in range(5):
            if device == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                call()
                times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    rel = lambda a, b: abs(a - b) / abs(b)
    rel_max = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()
    out = {"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu", "rows": []}

    def row(**r):
        out["rows"].append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)

    # c4 at each spatial size: the float32 problem solved in float64 first.
    for ns in c4_sizes:
        y = np.random.default_rng(0).standard_normal(ns * nt)
        y[min(4321, ns * nt - 1)] = np.nan
        dtype = torch.float32
        x = RectilinearGrid(torch.linspace(-3, 3, ns, dtype=dtype, device=device),
                            RegularSpacing(torch.tensor(0.0, dtype=dtype),
                                           torch.tensor(0.01, dtype=dtype), nt))
        model = build_lgssm(to_sde(GP(Separable(EQ().stretch(0.7), Matern52())),
                                   ArrayStorage(dtype), device=device)(x, 0.1))
        model_f, y_f, _ = transform_model_and_obs(
            model, torch.as_tensor(y, dtype=dtype, device=device).reshape(nt, ns))
        noise_pred = torch.diag_embed(torch.full((nt, ns), 0.1, dtype=dtype, device=device))

        def post_means(m, yy, engine, **kw):
            post = lgssm.posterior(m, yy, engine=engine, **kw)
            post = replace_observation_noise_cov(post, noise_pred.to(m.dtype))
            return lgssm.marginals_diag(post, engine=engine, **kw)[0]

        wide_model = widened(model_f)
        lml_ref = lgssm.logpdf(wide_model, y_f.double(), engine="sequential").item()
        means_ref = post_means(wide_model, y_f.double(), "sequential")
        runs = [("parallel", {})] + [("block", {} if b is None else {"n_blocks": b})
                                     for b in args.blocks]
        if ns == c4_sizes[0]:
            runs = [("sequential", {})] + runs
        plain = assoc._minv
        for label, minv in VARIANTS.items():
            assoc._minv = minv
            try:
                for engine, kw in runs:
                    if engine == "sequential" and label == "wide":
                        continue  # no inverse on the sequential engine
                    lml = lgssm.logpdf(model_f, y_f, engine=engine, **kw).item()
                    row(model="c4", D=model.latent_dim, inverse=label, engine=engine, **kw,
                        lml_rel=rel(lml, lml_ref),
                        post_means_rel=rel_max(post_means(model_f, y_f, engine, **kw), means_ref),
                        logpdf_ms=ms(lambda: lgssm.logpdf(model_f, y_f, engine=engine, **kw)),
                        posterior_means_ms=ms(lambda: post_means(model_f, y_f, engine, **kw)))
            finally:
                assoc._minv = plain

    # The small-D matrix paths and the associative engine at D = 3.
    y_np = np.random.default_rng(0).standard_normal(n_c2)
    y_np[1234] = np.nan
    times6 = np.cumsum(np.random.default_rng(0).uniform(0.5e-3, 1.5e-3, n_d6))

    def fx_of(name, dtype):
        if name == "d5":
            return to_sde(GP(Matern52() + Matern32()), ArrayStorage(dtype), device=device)(
                RegularSpacing(0.0, 1e-3, n_d5), 0.1)
        if name == "d6":
            return to_sde(GP(Matern52() + Matern52().stretch(3.0)), ArrayStorage(dtype),
                          device=device)(torch.as_tensor(times6, dtype=dtype, device=device), 0.1)
        return to_sde(GP(Matern52()), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, n_c2), 0.1)

    def call_of(name, fx, y):
        engine = "parallel" if name == "c2" else "block"
        if name == "d5":
            return lambda: gpost.marginals(gpost.posterior(fx, y)(fx.x, 0.1), engine=engine)[0]
        return lambda: logpdf(fx, y, engine=engine)

    for name, n in (("d5", n_d5), ("d6", n_d6), ("c2", n_c2)):
        ys = {dt: torch.as_tensor(y_np[:n], dtype=dt, device=device)
              for dt in (torch.float32, torch.float64)}
        want = call_of(name, fx_of(name, torch.float64), ys[torch.float64])()
        fx32 = fx_of(name, torch.float32)
        call = call_of(name, fx32, ys[torch.float32])
        plain = assoc._minv
        for label, minv in VARIANTS.items():
            assoc._minv = minv
            try:
                got = call()
                err = rel_max(got, want) if name == "d5" else rel(got.item(), want.item())
                row(model=name, D=build_lgssm(fx32).latent_dim, N=n, inverse=label,
                    call="posterior_marginals" if name == "d5" else "logpdf",
                    engine="parallel" if name == "c2" else "block", rel_vs_f64=err, ms=ms(call))
            finally:
                assoc._minv = plain
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
