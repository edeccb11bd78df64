"""Hyperparameter learning on a 1M-step time series (the reference's
examples/exact_time_learning.py): the mean, kernel variance, inverse
lengthscale and noise variance, by Adam on the state-space log marginal
likelihood and its forward-mode gradient (value_and_grad_fwd_lgssm: the
lml and its four derivatives in one pass of the block engine), then the
posterior at the learned values.
"""

import torch

from temporalgps_torch import RegularSpacing, fit, positive, value_and_grad_fwd_lgssm
from temporalgps_torch.gp import GP, ConstMean, Matern52, build_lgssm, rand, to_sde
from temporalgps_torch.gp.posterior import marginals as post_marginals
from temporalgps_torch.gp.posterior import posterior

from ._common import DEVICE, generator, scaled


def build_gp(p):
    """p = (mean, log kernel variance, log inverse lengthscale, log noise
    variance) -> (the LTISDE, the noise variance)."""
    mean, log_var, log_lambda, log_noise = p
    kern = (torch.exp(log_var) * Matern52()).stretch(torch.exp(log_lambda))
    return to_sde(GP(kern, ConstMean(mean)), device=DEVICE), torch.exp(log_noise)


def main():
    T = scaled(1_000_000, 2_000)
    x = RegularSpacing(0.0, 1e-4, T)

    true_p = torch.stack([torch.tensor(3.0, dtype=torch.float64, device=DEVICE)]
                         + [positive(v, device=DEVICE) for v in (0.6, 0.1, 2.0)])
    f_true, noise_true = build_gp(true_p)
    y = rand(generator(0), f_true(x, noise_true))

    def model_fn(p):
        f, noise = build_gp(p)
        return build_lgssm(f(x, noise))

    vg = value_and_grad_fwd_lgssm(model_fn, y)

    def objective(p):
        value, grad = vg(p)
        return -value / T, -grad / T

    shift = 0.3 * torch.randn((), generator=generator(1), dtype=torch.float64, device=DEVICE)
    result = fit(objective, true_p + shift, steps=scaled(150, 10), has_grad=True)
    losses = result.losses.tolist()
    print("loss trajectory:", losses[:: max(1, len(losses) // 8)])
    print("learned:", result.params.tolist())

    f_final, noise = build_gp(result.params)
    fp = posterior(f_final(x, noise), y)
    m, _ = post_marginals(fp(x, noise))
    assert bool(torch.isfinite(m).all()) and all(map(torch.isfinite, result.losses))
    print("ok")


if __name__ == "__main__":
    main()
