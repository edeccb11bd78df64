"""Non-Gaussian likelihoods by variable augmentation (the reference's
examples/augmented_inference.py): binary classification with a logistic
link, by the Polya-Gamma augmentation of Galy-Fajou et al. (2020). Each
CAVI iteration is the posterior of a GP with heteroscedastic noise, which
the state-space smoother computes in O(N).
"""

import math

import torch

from temporalgps_torch import RegularSpacing
from temporalgps_torch.gp import GP, Matern52, rand, to_sde
from temporalgps_torch.gp.posterior import marginals as post_marginals
from temporalgps_torch.gp.posterior import posterior

from ._common import DEVICE, generator, scaled


def main():
    T = scaled(1_000, 300)
    x = RegularSpacing(0.0, 1e-1, T)
    f = to_sde(GP(Matern52()), device=DEVICE)

    f_true = rand(generator(0), f(x, 0.01))
    probs = torch.sigmoid(f_true)
    u = torch.rand(T, generator=generator(1), dtype=torch.float64, device=DEVICE)
    y = (u < probs).to(torch.float64)
    y_sign = 2.0 * y - 1.0

    gamma = 0.5
    g = 0.5 * y_sign
    beta = 0.0

    omega = torch.ones(T, dtype=torch.float64, device=DEVICE)
    for _ in range(scaled(8, 5)):
        Lam = 2.0 * gamma * omega
        fp = posterior(f(x, 1.0 / Lam), (g + beta * omega) / Lam)
        m, v = post_marginals(fp(x, 1e-12))
        c = torch.sqrt(v + m**2) / 2.0
        omega = 0.5 * torch.tanh(c) / c

    # The final posterior's predictive class probabilities.
    Lam = 2.0 * gamma * omega
    fp = posterior(f(x, 1.0 / Lam), (g + beta * omega) / Lam)
    m, v = post_marginals(fp(x, 1e-12))
    p_hat = torch.sigmoid(m / torch.sqrt(1 + math.pi * v / 8))
    acc = ((p_hat > 0.5) == y.bool()).double().mean().item()
    print(f"train accuracy vs sampled labels: {acc:.3f}")
    assert acc > 0.55
    print("ok")


if __name__ == "__main__":
    main()
