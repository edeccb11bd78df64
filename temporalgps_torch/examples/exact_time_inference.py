"""Exact GP time-series inference at scale (the reference's
examples/exact_time_inference.py): a Matern-5/2 GP in state-space form, 1M
noisy observations sampled from it, the posterior, and its marginals at 1.2M
time points.
"""

import torch

from temporalgps_torch import RegularSpacing
from temporalgps_torch.gp import GP, Matern52, rand, to_sde
from temporalgps_torch.gp.posterior import marginals as post_marginals
from temporalgps_torch.gp.posterior import posterior

from ._common import DEVICE, generator, scaled


def main():
    T = scaled(1_000_000, 2_000)
    T_pr = scaled(1_200_000, 2_400)
    x = RegularSpacing(0.0, 1e-4, T)
    f = to_sde(GP(Matern52()), device=DEVICE)
    var_noise = 0.1

    fx = f(x, var_noise)
    y = rand(generator(42), fx)

    f_post = posterior(fx, y)
    x_pr = RegularSpacing(0.0, 1e-4 * T / T_pr, T_pr)
    m, v = post_marginals(f_post(x_pr, var_noise))
    print(f"T={T} T_pr={T_pr} on {m.device}")
    print("posterior mean head:", m[:5].tolist())
    print("posterior std head :", torch.sqrt(v[:5]).tolist())
    assert bool(torch.isfinite(m).all()) and bool((v > 0).all())
    print("ok")


if __name__ == "__main__":
    main()
