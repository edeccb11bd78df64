"""Where the device time of one Fisher-gradient call goes, and what the
batched small-matrix solvers it could use cost, on one card:

    python3 probes/torch_fisher_ops.py

c2's model, (s2 * Matern52()).stretch(sc) on RegularSpacing(0, 1e-3, 1M),
noise 0.1, one NaN, s2 = sc = 1; value_and_grad_fisher(model_fn, y,
engine="block") at float32 and float64. For each dtype it prints the
torch.profiler table of one call (the 25 ops with the most device time),
then the median of 5 CUDA-event timings of each batched op on 1M random
(3, 3) SPD matrices: torch.linalg.cholesky, torch.cholesky_solve (matrix
and vector right-hand sides), psd.chol_solve (two triangular solves),
torch.linalg.solve_triangular, torch.cholesky_inverse, torch.linalg.inv,
a batched matmul and a batched matrix-vector einsum.
"""

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch import RegularSpacing  # noqa: E402
from temporalgps_torch.gp import GP, ArrayStorage, Matern52, build_lgssm, to_sde  # noqa: E402
from temporalgps_torch.learning import value_and_grad_fisher  # noqa: E402
from temporalgps_torch.ops import kernels  # noqa: E402
from temporalgps_torch.utils import psd  # noqa: E402

N = 1_000_000


def events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    from torch.profiler import ProfilerActivity, profile

    kernels.build()
    y = np.random.default_rng(0).standard_normal(N)
    y[123_456] = np.nan
    p0 = torch.tensor([0.0, 0.0, math.log(0.1)], dtype=torch.float64, device="cuda")
    for dtype in (torch.float32, torch.float64):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)), ArrayStorage(dtype))(
                RegularSpacing(0.0, 1e-3, N), noise))

        vg = value_and_grad_fisher(model_fn, y, engine="block")
        print(dtype, "value_and_grad_fisher:", events_ms(lambda: vg(p0)), "ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vg(p0)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                        max_name_column_width=70), flush=True)
        A = torch.randn(N, 3, 3, dtype=dtype, device="cuda")
        P = A @ A.mT + 0.1 * torch.eye(3, dtype=dtype, device="cuda")
        L = torch.linalg.cholesky(P)
        B = torch.randn(N, 3, 3, dtype=dtype, device="cuda")
        eye = torch.eye(3, dtype=dtype, device="cuda").expand(N, 3, 3)
        for name, fn in (("torch.linalg.cholesky", lambda: torch.linalg.cholesky(P)),
                         ("torch.cholesky_solve", lambda: torch.cholesky_solve(B, L)),
                         ("torch.cholesky_solve, vector", lambda: torch.cholesky_solve(B[..., :1], L)),
                         ("psd.chol_solve", lambda: psd.chol_solve(L, B)),
                         ("psd.chol_solve, vector", lambda: psd.chol_solve(L, B[..., :1])),
                         ("torch.linalg.solve_triangular", lambda: torch.linalg.solve_triangular(
                             L, eye, upper=False)),
                         ("torch.cholesky_inverse", lambda: torch.cholesky_inverse(L)),
                         ("torch.linalg.inv", lambda: torch.linalg.inv(P)),
                         ("batched matmul", lambda: P @ B),
                         ("batched einsum matrix-vector",
                          lambda: torch.einsum("nij,nj->ni", P, B[..., 0]))):
            print(f"{dtype} {name}: {events_ms(fn)!r} ms", flush=True)


if __name__ == "__main__":
    main()
