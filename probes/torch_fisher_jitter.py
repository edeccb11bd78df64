"""What the smoother's jitter does to the Fisher gradient, on the CPU:

    python3 probes/torch_fisher_jitter.py [N ...]

c2's model, (s2 * Matern52()).stretch(sc) on RegularSpacing(0, 1e-3, N)
(lam dt = 2.2e-3), noise 0.1, s2 = sc = 1, y from default_rng(0) with a NaN
at min(123456, N // 3). For each N (20000 and 100000 unless given) it
prints value_and_grad_fisher (engine="block", the kernels' plain versions)
against value_and_grad_fwd_lgssm, per component relative, in float64 and
float32, with the posterior that the Fisher statistics take inverting its
predicted covariances exactly (jitter 0, the port's) and with the
reference's POSTERIOR_JITTER = 1e-10 on them.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch import RegularSpacing, value_and_grad_fwd_lgssm  # noqa: E402
from temporalgps_torch.config import POSTERIOR_JITTER  # noqa: E402
from temporalgps_torch.gp import GP, ArrayStorage, Matern52, build_lgssm, to_sde  # noqa: E402
from temporalgps_torch.learning import value_and_grad_fisher  # noqa: E402
from temporalgps_torch.ops import fisher  # noqa: E402


def model_fn_of(dtype, N):
    def model_fn(p):
        s2, sc, noise = torch.exp(p)
        return build_lgssm(to_sde(GP((s2 * Matern52()).stretch(sc)), ArrayStorage(dtype),
                                  device="cpu")(RegularSpacing(0.0, 1e-3, N), noise))

    return model_fn


def main():
    torch.set_num_threads(4)
    p0 = torch.tensor([0.0, 0.0, np.log(0.1)], dtype=torch.float64)
    exact = fisher._exact_posterior
    for N in [int(a) for a in sys.argv[1:]] or [20_000, 100_000]:
        y = np.random.default_rng(0).standard_normal(N)
        y[min(123_456, N // 3)] = np.nan
        _, g = value_and_grad_fwd_lgssm(model_fn_of(torch.float64, N), y)(p0)
        print(f"N={N}: forward-mode gradient (float64) {g.tolist()}")
        for jitter in (0.0, POSTERIOR_JITTER):
            fisher._exact_posterior = (exact if jitter == 0.0 else
                                       lambda model, filt: exact(model, filt, jitter))
            try:
                for dtype in (torch.float64, torch.float32):
                    _, gf = value_and_grad_fisher(model_fn_of(dtype, N), y, engine="block")(p0)
                    r = ((gf.double() - g).abs() / g.abs()).tolist()
                    print(f"  jitter {jitter:g} {dtype}: per component {['%.3e' % v for v in r]}")
            finally:
                fisher._exact_posterior = exact


if __name__ == "__main__":
    main()
