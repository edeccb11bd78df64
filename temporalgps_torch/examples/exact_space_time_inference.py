"""Exact spatio-temporal inference on a space x time grid (the reference's
examples/exact_space_time_inference.py): a Separable(EQ, Matern-5/2) kernel
on 50 points x 1000 times; noisy data sampled from it, the posterior, and
its marginals at the same points over an extended time horizon.
"""

import torch

from temporalgps_torch import RegularSpacing
from temporalgps_torch.gp import EQ, GP, Matern52, rand, to_sde
from temporalgps_torch.gp.posterior import marginals as post_marginals
from temporalgps_torch.gp.posterior import posterior
from temporalgps_torch.space_time import RectilinearGrid, Separable

from ._common import DEVICE, generator, scaled


def main():
    Ns = scaled(50, 6)
    Nt = scaled(1_000, 40)
    r = torch.linspace(-3.0, 3.0, Ns, dtype=torch.float64, device=DEVICE)
    x = RectilinearGrid(r, RegularSpacing(0.0, 0.01, Nt))
    k = Separable(EQ().stretch(0.7), Matern52())
    f = to_sde(GP(k), device=DEVICE)
    var_noise = 0.1

    fx = f(x, var_noise)
    y = rand(generator(0), fx)
    print("sampled", tuple(y.shape))

    fp = posterior(fx, y)
    # predict over an extended time horizon at the same spatial points
    Nt_pr = scaled(1_200, 50)
    x_pr = RectilinearGrid(r, RegularSpacing(0.0, 0.01 * Nt / Nt_pr, Nt_pr))
    m, v = post_marginals(fp(x_pr, var_noise))
    assert m.shape == (Ns * Nt_pr,)
    assert bool(torch.isfinite(m).all()) and bool((v > 0).all())
    print("posterior mean/std head:", m[:4].tolist(), torch.sqrt(v[:4]).tolist())
    print("ok")


if __name__ == "__main__":
    main()
