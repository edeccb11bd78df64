"""Carry a model across from the reference package as numpy values, so that
both packages compute the same thing on the same parameters. No JAX here:
the caller turns the reference's arrays into numpy first.
"""

import numpy as np
import torch

from .gp import kernels as K
from .gp import means
from .models.emissions import DenseEmissions, ScalarEmissions
from .models.gauss_markov import GaussMarkov
from .models.lgssm import LGSSM
from .utils.fill import Fill
from .utils.gaussian import Gaussian


def _leaf(value, N, time_ndim, dtype, device):
    """A per-step leaf: a Fill for a value of the per-step rank `time_ndim`,
    a tensor with a leading time axis otherwise."""
    t = torch.tensor(np.asarray(value), dtype=dtype, device=device)
    return Fill(t, N) if t.ndim == time_ndim else t


def _trans_from_numpy(As, offs, Qs, x0_mean, x0_cov, N, dtype, device, forward, det_blocks):
    leaf = lambda v, nd: _leaf(v, N, nd, dtype, device)
    x0 = Gaussian(
        torch.tensor(np.asarray(x0_mean), dtype=dtype, device=device),
        torch.tensor(np.asarray(x0_cov), dtype=dtype, device=device),
    )
    return GaussMarkov(As=leaf(As, 2), offs=leaf(offs, 1), Qs=leaf(Qs, 2), x0=x0, forward=forward,
                       det_blocks=det_blocks)


def lgssm_from_numpy(As, offs, Qs, H, h, s, x0_mean, x0_cov, N, *, dtype, device="cuda",
                     forward=True, det_blocks=False):
    """The port's LGSSM from the reference LGSSM's leaves: each of As (D, D),
    offs (D,), Qs (D, D), H (D,), h (), s () is a Fill value, or the same with
    a leading time axis of length N (s is typically (N,)). `forward` is the
    reference's `trans.forward`: False for a smoother's posterior, whose
    transition leaves are per step; `det_blocks` its `trans.det_blocks`
    (a kernel with a Cosine, Constant or ApproxPeriodic summand). The leaves
    of a tangent model (the
    reference's jax.jvp of its model function) come across the same way. On
    the card unless the caller passes device="cpu"."""
    leaf = lambda v, nd: _leaf(v, N, nd, dtype, device)
    return LGSSM(_trans_from_numpy(As, offs, Qs, x0_mean, x0_cov, N, dtype, device, forward,
                                   det_blocks),
                 ScalarEmissions(H=leaf(H, 1), h=leaf(h, 0), s=leaf(s, 0)))


def dense_lgssm_from_numpy(As, offs, Qs, H, h, S, x0_mean, x0_cov, N, *, dtype, device="cuda",
                           forward=True, det_blocks=False):
    """`lgssm_from_numpy` for a reference LGSSM with DenseEmissions (a
    space-time model): H (Dout, D), h (Dout,) and S (Dout, Dout), each a Fill
    value or per step."""
    leaf = lambda v, nd: _leaf(v, N, nd, dtype, device)
    return LGSSM(_trans_from_numpy(As, offs, Qs, x0_mean, x0_cov, N, dtype, device, forward,
                                   det_blocks),
                 DenseEmissions(H=leaf(H, 2), h=leaf(h, 1), S=leaf(S, 2)))


def tangent_lgssms_from_numpy(tangent_leaves, N, *, dtype, device="cuda"):
    """The port's `model_tangents` (ops.block.logpdf_fwd_grad) from k tuples
    (As, offs, Qs, H, h, s, x0_mean, x0_cov) of tangent leaves as numpy."""
    return [lgssm_from_numpy(*leaves, N, dtype=dtype, device=device)
            for leaves in tangent_leaves]


_ATOMS = {"Matern12": K.Matern12, "Matern32": K.Matern32, "Matern52": K.Matern52, "EQ": K.EQ,
          "Cosine": K.Cosine}


def kernel_from_spec(spec):
    """The port's kernel from a nested spec of names and numpy scalars:
    ("Matern12",), ("Matern32",), ("Matern52",), ("EQ",), ("Cosine",),
    ("Constant", c), ("ApproxPeriodic", r, n_cos), ("Scaled", child,
    sigma2), ("Stretched", child, s), ("Sum", (child, ...)), ("Product",
    (child, ...)), ("Separable", space_child, time_child) or
    ("DTCSeparable", z, separable_spec), z the pseudo-inputs (a tensor).
    Hyperparameters become Python floats."""
    name = spec[0]
    if name in _ATOMS:
        return _ATOMS[name]()
    if name == "Separable":
        from .space_time import Separable

        return Separable(kernel_from_spec(spec[1]), kernel_from_spec(spec[2]))
    if name == "DTCSeparable":
        from .space_time import DTCSeparable

        return DTCSeparable(torch.tensor(np.asarray(spec[1])), kernel_from_spec(spec[2]))
    if name == "Constant":
        return K.Constant(float(np.asarray(spec[1])))
    if name == "ApproxPeriodic":
        return K.ApproxPeriodic(float(np.asarray(spec[1])), int(spec[2]))
    if name == "Scaled":
        return K.Scaled(kernel_from_spec(spec[1]), float(np.asarray(spec[2])))
    if name == "Stretched":
        return K.Stretched(kernel_from_spec(spec[1]), float(np.asarray(spec[2])))
    if name in ("Sum", "Product"):
        return getattr(K, name)(tuple(kernel_from_spec(c) for c in spec[1]))
    raise ValueError(f"no kernel spec {name!r}")


def mean_from_spec(spec):
    """The port's mean function from ("ZeroMean",) or ("ConstMean", c), c a
    numpy scalar. A CustomMean carries a callable, which a caller hands to
    both packages itself."""
    if spec[0] == "ZeroMean":
        return means.ZeroMean()
    if spec[0] == "ConstMean":
        return means.ConstMean(float(np.asarray(spec[1])))
    raise ValueError(f"no mean spec {spec[0]!r}")
