"""Carry a model across from the reference package as numpy values, so that
both packages compute the same thing on the same parameters. No JAX here:
the caller turns the reference's arrays into numpy first.
"""

import numpy as np
import torch

from .gp import kernels as K
from .models.emissions import ScalarEmissions
from .models.gauss_markov import GaussMarkov
from .models.lgssm import LGSSM
from .utils.fill import Fill
from .utils.gaussian import Gaussian


def _leaf(value, N, time_ndim, dtype, device):
    """A per-step leaf: a Fill for a value of the per-step rank `time_ndim`,
    a tensor with a leading time axis otherwise."""
    t = torch.tensor(np.asarray(value), dtype=dtype, device=device)
    return Fill(t, N) if t.ndim == time_ndim else t


def lgssm_from_numpy(As, offs, Qs, H, h, s, x0_mean, x0_cov, N, *, dtype, device="cuda"):
    """The port's LGSSM from the reference LGSSM's leaves: each of As (D, D),
    offs (D,), Qs (D, D), H (D,), h (), s () is a Fill value, or the same with
    a leading time axis of length N (s is typically (N,)). The leaves of a
    tangent model (the reference's jax.jvp of its model function) come across
    the same way. On the card unless the caller passes device="cpu"."""
    leaf = lambda v, nd: _leaf(v, N, nd, dtype, device)
    x0 = Gaussian(
        torch.tensor(np.asarray(x0_mean), dtype=dtype, device=device),
        torch.tensor(np.asarray(x0_cov), dtype=dtype, device=device),
    )
    return LGSSM(
        GaussMarkov(As=leaf(As, 2), offs=leaf(offs, 1), Qs=leaf(Qs, 2), x0=x0, forward=True),
        ScalarEmissions(H=leaf(H, 1), h=leaf(h, 0), s=leaf(s, 0)),
    )


def tangent_lgssms_from_numpy(tangent_leaves, N, *, dtype, device="cuda"):
    """The port's `model_tangents` (ops.block.logpdf_fwd_grad) from k tuples
    (As, offs, Qs, H, h, s, x0_mean, x0_cov) of tangent leaves as numpy."""
    return [lgssm_from_numpy(*leaves, N, dtype=dtype, device=device)
            for leaves in tangent_leaves]


_ATOMS = {"Matern12": K.Matern12, "Matern32": K.Matern32, "Matern52": K.Matern52}


def kernel_from_spec(spec):
    """The port's kernel from a nested spec of names and numpy scalars:
    ("Matern12",), ("Matern32",), ("Matern52",), ("Scaled", child, sigma2) or
    ("Stretched", child, s). Hyperparameters become Python floats."""
    name = spec[0]
    if name in _ATOMS:
        return _ATOMS[name]()
    if name == "Scaled":
        return K.Scaled(kernel_from_spec(spec[1]), float(np.asarray(spec[2])))
    if name == "Stretched":
        return K.Stretched(kernel_from_spec(spec[1]), float(np.asarray(spec[2])))
    raise NotImplementedError(f"kernel {name!r} is not ported yet (ROADMAP Queue 1 items 2 and 9)")
