"""Hyperparameter learning for an exact spatio-temporal model (the
reference's examples/exact_space_time_learning.py): the kernel variance,
the spatial and temporal inverse lengthscales and the noise variance on a
space x time grid, by Adam on the exact state-space lml (autograd).
"""

import torch

from temporalgps_torch import RegularSpacing, fit, positive
from temporalgps_torch.gp import EQ, GP, Matern52, logpdf, rand, to_sde
from temporalgps_torch.space_time import RectilinearGrid, Separable

from ._common import DEVICE, generator, scaled


def build_gp(p):
    """p = the logs of (kernel variance, spatial inverse lengthscale,
    temporal inverse lengthscale, noise variance) -> (the LTISDE, the noise
    variance)."""
    var, inv_space, inv_time, noise = torch.exp(p)
    kern = var * Separable(EQ().stretch(inv_space), Matern52().stretch(inv_time))
    return to_sde(GP(kern), device=DEVICE), noise


def main():
    Ns = scaled(50, 5)
    Nt = scaled(1_000, 30)
    r = torch.linspace(-3.0, 3.0, Ns, dtype=torch.float64, device=DEVICE)
    x = RectilinearGrid(r, RegularSpacing(0.0, 0.02, Nt))

    true_p = torch.stack([positive(v, device=DEVICE) for v in (0.8, 0.9, 1.2, 0.3)])
    f_true, noise_true = build_gp(true_p)
    y = rand(generator(0), f_true(x, noise_true))

    def objective(p):
        f, noise = build_gp(p)
        return -logpdf(f(x, noise), y) / (Ns * Nt)

    result = fit(objective, true_p + 0.2, steps=scaled(100, 8))
    print("learned:", torch.exp(result.params).tolist())
    assert bool(torch.isfinite(result.losses[-1]))
    print("ok")


if __name__ == "__main__":
    main()
