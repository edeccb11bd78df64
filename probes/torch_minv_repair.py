"""The matrix path's inverse (I + C J)^{-1} (ops/assoc.py `_minv`) for D > 3,
three ways, on the CPU:

    python3 probes/torch_minv_repair.py [N]

  - "jittered": the reference's Cholesky congruence, C = Lc Lc^T with a
    jitter of 1e-10 (float64) or 3e-6 times the largest diagonal entry
    (float32), (I + C J)^{-1} = Lc (I + Lc^T J Lc)^{-1} Lc^{-1};
  - "plain": the LU inverse in the model's dtype (the port's choice);
  - "float64": the LU inverse formed in float64 and stored in the model's
    dtype.

Models: the D = 5 sum Matern52() + Matern32() and the D = 6 sum Matern52()
+ Matern52().stretch(3.0), on RegularSpacing(0, 1e-3, N) (N = 2000 unless
given), noise 0.1, y from default_rng(0) with a NaN at N // 3. For each
variant and dtype it prints the block engine's posterior means at the
training inputs against the float64 sequential engine's, relative to the
largest entry, and the block lml's relative distance to the sequential
lml; beside them the float32 sequential engine's means.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch import RegularSpacing, logpdf  # noqa: E402
from temporalgps_torch.gp import GP, ArrayStorage, Matern32, Matern52, to_sde  # noqa: E402
from temporalgps_torch.gp import posterior as gpost  # noqa: E402
from temporalgps_torch.ops import assoc  # noqa: E402
from temporalgps_torch.utils.psd import symmetrize  # noqa: E402

MODELS = {"D5": lambda: Matern52() + Matern32(),
          "D6": lambda: Matern52() + Matern52().stretch(3.0)}


def jittered(C, J):
    D = C.shape[-1]
    I = torch.eye(D, dtype=C.dtype)
    Cs = symmetrize(C)
    if C.dtype == torch.float64:
        eps = 1e-10
    else:
        eps = 3e-6 * torch.diagonal(Cs, dim1=-2, dim2=-1).abs().amax(-1).clamp_min(1.0)
        eps = eps[..., None, None]
    Lc = torch.linalg.cholesky(Cs + eps * I)
    Ls = torch.linalg.cholesky(symmetrize(Lc.mT @ J @ Lc) + I)
    Lc_inv = torch.linalg.solve_triangular(Lc, I.expand(Lc.shape), upper=False)
    return Lc @ torch.cholesky_solve(Lc_inv, Ls)


def wide(C, J):
    I = torch.eye(C.shape[-1], dtype=torch.float64)
    return torch.linalg.inv(I + C.double() @ J.double()).to(C.dtype)


VARIANTS = {"jittered": jittered, "plain": assoc._minv, "float64": wide}


def rel(a, b):
    return ((a.double() - b).abs().max() / b.abs().max()).item()


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    torch.set_num_threads(4)
    y = np.random.default_rng(0).standard_normal(N)
    y[N // 3] = np.nan
    x = RegularSpacing(0.0, 1e-3, N)
    port_minv = assoc._minv
    for label, kern in MODELS.items():
        fx = {dt: to_sde(GP(kern()), ArrayStorage(dt), device="cpu")(x, 0.1)
              for dt in (torch.float32, torch.float64)}

        def means(dtype, engine):
            f = fx[dtype]
            return gpost.marginals(gpost.posterior(f, y)(f.x, 0.1), engine=engine)[0]

        truth = means(torch.float64, "sequential")
        lml_seq = logpdf(fx[torch.float64], y, engine="sequential").item()
        print(f"{label} N={N}: float32 sequential means {rel(means(torch.float32, 'sequential'), truth):.3e}")
        for name, fn in VARIANTS.items():
            assoc._minv = fn
            try:
                r32 = rel(means(torch.float32, "block"), truth)
                r64 = rel(means(torch.float64, "block"), truth)
                lml = logpdf(fx[torch.float64], y, engine="block").item()
            finally:
                assoc._minv = port_minv
            print(f"  {name:9s} block means float32 {r32:.3e}, float64 {r64:.3e}; "
                  f"float64 lml vs sequential {abs(lml - lml_seq) / abs(lml_seq):.3e}")


if __name__ == "__main__":
    main()
