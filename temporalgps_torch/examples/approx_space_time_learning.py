"""Pseudo-point spatio-temporal learning on ragged data (the reference's
examples/approx_space_time_learning.py): RegularInTime inputs (25-50
points at each of 1000 irregular times), Adam on the negative ELBO per
observation (the port's `fit`, autograd), then the approximate posterior
at new points.
"""

import numpy as np
import torch

from temporalgps_torch import fit, positive
from temporalgps_torch.gp import EQ, GP, Matern52, to_sde
from temporalgps_torch.space_time import (Separable, approx_posterior_marginals, elbo,
                                          regular_in_time)

from ._common import DEVICE, scaled


def build_gp(p):
    """p = the logs of (kernel variance, spatial inverse lengthscale,
    temporal inverse lengthscale, noise variance) -> (the LTISDE, the noise
    variance)."""
    var, inv_space, inv_time, noise = torch.exp(p)
    kern = var * Separable(EQ().stretch(inv_space), Matern52().stretch(inv_time))
    return to_sde(GP(kern), device=DEVICE), noise


def main():
    rng = np.random.default_rng(0)
    Nt = scaled(1_000, 25)
    M = scaled(5, 3)
    max_pts = scaled(50, 5)
    ts = np.cumsum(0.01 + rng.random(Nt) * 0.01)
    vs = [np.sort(rng.uniform(-3, 3, rng.integers(max_pts // 2, max_pts + 1)))
          for _ in range(Nt)]
    x = regular_in_time(ts, vs)
    n_obs = len(x)
    y = torch.as_tensor(rng.standard_normal(n_obs), device=DEVICE)
    z = torch.linspace(-3.0, 3.0, M, dtype=torch.float64, device=DEVICE)

    def objective(p):
        f, noise = build_gp(p)
        return -elbo(f(x, noise), y, z) / n_obs

    p0 = torch.stack([positive(v, device=DEVICE) for v in (1.0, 1.0, 1.0, 0.5)])
    result = fit(objective, p0, steps=scaled(75, 6))
    print("learned:", torch.exp(result.params).tolist())
    assert bool(torch.isfinite(result.losses[-1]))

    f, noise = build_gp(result.params.detach())
    r_pr = torch.linspace(-3.0, 3.0, scaled(25, 7), dtype=torch.float64, device=DEVICE)
    m, v = approx_posterior_marginals(f(x, noise), y, z, r_pr)
    assert bool(torch.isfinite(m).all())
    print("ok")


if __name__ == "__main__":
    main()
