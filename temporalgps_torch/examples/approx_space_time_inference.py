"""Approximate (pseudo-point) spatio-temporal inference (the reference's
examples/approx_space_time_inference.py): the DTC approximation with M
spatial inducing points on a 50 x 1000 grid, its ELBO, and the approximate
posterior marginals on a finer spatial grid.
"""

import torch

from temporalgps_torch import RegularSpacing
from temporalgps_torch.gp import EQ, GP, Matern52, rand, to_sde
from temporalgps_torch.space_time import (RectilinearGrid, Separable, approx_posterior_marginals,
                                          elbo)

from ._common import DEVICE, generator, scaled


def main():
    Ns = scaled(50, 6)
    Nt = scaled(1_000, 40)
    M = scaled(10, 4)
    r = torch.linspace(-3.0, 3.0, Ns, dtype=torch.float64, device=DEVICE)
    x = RectilinearGrid(r, RegularSpacing(0.0, 0.01, Nt))
    f = to_sde(GP(Separable(EQ().stretch(0.5), Matern52())), device=DEVICE)
    fx = f(x, 0.1)
    y = rand(generator(0), fx)

    z = torch.linspace(-3.0, 3.0, M, dtype=torch.float64, device=DEVICE)
    print("elbo:", elbo(fx, y, z).item())

    r_pr = torch.linspace(-3.2, 3.2, scaled(100, 9), dtype=torch.float64, device=DEVICE)
    m, v = approx_posterior_marginals(fx, y, z, r_pr)
    assert m.shape == (len(r_pr) * Nt,)
    assert bool(torch.isfinite(m).all()) and bool((v > -1e-9).all())
    print("approx posterior head:", m[:4].tolist(), torch.sqrt(v[:4].clamp_min(0)).tolist())
    print("ok")


if __name__ == "__main__":
    main()
