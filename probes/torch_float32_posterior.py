"""Where a float32 posterior sample of sum-c2 parts from float64, on the CPU
(the block engine's plain versions, the same arithmetic as the kernels up
to FMA contraction).

    python3 probes/torch_float32_posterior.py [N ...]

sum-c2's kernel (0.5 * Matern12().stretch(2.0) + Matern32().stretch(0.5),
noise 0.1) on RegularSpacing(0, 1e-3, N), y from default_rng(0) with a NaN
at N // 3; the posterior at the training inputs (merged with themselves,
2N steps) sampled on the same normals (default_rng(5)) through
rand_with_eps. For each N it prints, each relative to the largest entry:
  - the float32 sample against the float64 one;
  - the float32 problem (the float32 model and data, every leaf cast to
    float64) solved in float64, against the float64 sample: the share of
    float32 storage;
  - the float32 sample against that problem's: the share of float32
    arithmetic;
  - for N <= 20000, the float64 sample of the sequential engine's
    posterior (the reverse dynamics by a Cholesky solve) against the block
    engine's (the adjugate), at normals from default_rng(5) and (6);
  - for N <= 5000, the D = 5 sum Matern52() + Matern32()'s posterior means
    at the training inputs, float32 against float64 (the matrix path).
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from temporalgps_torch import RegularSpacing  # noqa: E402
from temporalgps_torch.gp import (GP, ArrayStorage, Matern12, Matern32, Matern52,  # noqa: E402
                                  to_sde)
from temporalgps_torch.gp import posterior as gpost  # noqa: E402
from temporalgps_torch.gp.lti_sde import build_lgssm  # noqa: E402
from temporalgps_torch.models import lgssm as tlgssm  # noqa: E402
from temporalgps_torch.models.missings import (posterior_with_missings,  # noqa: E402
                                               replace_observation_noise_cov)
from temporalgps_torch.utils.fill import is_fill  # noqa: E402

SUM = lambda: 0.5 * Matern12().stretch(2.0) + Matern32().stretch(0.5)


def rel(a, b):
    return ((a.double() - b).abs().max() / b.abs().max()).item()


def normals(n, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype)
            for a in (rng.standard_normal((n, D)), rng.standard_normal(n), rng.standard_normal(D))]


def widened(model):
    """`model` with every leaf cast to float64, its values kept."""
    wide = lambda leaf: (dataclasses.replace(leaf, value=leaf.value.double())
                         if is_fill(leaf) else leaf.double())
    t, e = model.trans, model.emis
    x0 = dataclasses.replace(t.x0, mean=t.x0.mean.double(), cov=t.x0.cov.double())
    return dataclasses.replace(
        model, trans=dataclasses.replace(t, As=wide(t.As), offs=wide(t.offs), Qs=wide(t.Qs),
                                         x0=x0),
        emis=dataclasses.replace(e, H=wide(e.H), h=wide(e.h), s=wide(e.s)))


def posterior_at_training(kern, dtype, N, y):
    fx = to_sde(GP(kern), ArrayStorage(dtype), device="cpu")(RegularSpacing(0.0, 1e-3, N), 0.1)
    return gpost.posterior(fx, torch.as_tensor(y, dtype=dtype))(fx.x, 0.1)


def sample(fxp, dtype, engine="block", seed=5):
    post, idx = gpost._merged_posterior(fxp, engine)
    return tlgssm.rand_with_eps(post, *normals(len(post), post.latent_dim, dtype, seed),
                                engine=engine)[idx]


def float32_problem_sample(fxp):
    """The float32 posterior's sample, its model and data as float32 stores
    them, solved in float64."""
    fp = fxp.f
    x_sorted, noise_all, y_all, _tr_idx, pr_idx = gpost._build_inference_data(fp, fxp.x)
    post = replace_observation_noise_cov(
        posterior_with_missings(widened(build_lgssm(fp.prior(x_sorted, noise_all))),
                                y_all.double(), engine="block"),
        gpost._pred_noise_full(pr_idx, len(x_sorted), fxp.noise, torch.float64, "cpu"))
    return tlgssm.rand_with_eps(post, *normals(len(post), post.latent_dim, torch.float64, 5),
                                engine="block")[torch.as_tensor(pr_idx)]


def main(sizes):
    torch.set_num_threads(4)
    for N in sizes:
        y = np.random.default_rng(0).standard_normal(N)
        y[N // 3] = np.nan
        fxp32 = posterior_at_training(SUM(), torch.float32, N, y)
        fxp64 = posterior_at_training(SUM(), torch.float64, N, y)
        s32, s64 = sample(fxp32, torch.float32), sample(fxp64, torch.float64)
        problem = float32_problem_sample(fxp32)
        print(f"N={N}: float32 sample vs float64 {rel(s32, s64)!r}; the float32 problem in "
              f"float64 vs float64 {rel(problem, s64)!r}; the float32 sample vs it "
              f"{rel(s32, problem)!r}", flush=True)
        if N <= 20000:
            for seed in (5, 6):
                seq = sample(fxp64, torch.float64, "sequential", seed)
                print(f"  seed {seed}: the sequential engine's float64 sample vs the block "
                      f"engine's {rel(sample(fxp64, torch.float64, seed=seed), seq)!r}",
                      flush=True)
        if N <= 5000:
            d5 = {dtype: gpost.marginals(posterior_at_training(Matern52() + Matern32(), dtype,
                                                               N, y), engine="block")[0]
                  for dtype in (torch.float32, torch.float64)}
            print(f"  D = 5: posterior means float32 vs float64 "
                  f"{rel(d5[torch.float32], d5[torch.float64])!r}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2000, 20000, 200000])
