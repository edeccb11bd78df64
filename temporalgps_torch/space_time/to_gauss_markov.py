"""The exact space-time compiler: a Separable kernel on a RectilinearGrid ->
LGSSM components (temporalgps_tpu/space_time/to_gauss_markov.py).

The temporal state-space model is tensored with the spatial covariance:

    As = I_Ns (x) A_t,   Qs = Kr (x) Q_t,   Hs = I_Ns (x) H_t,
    x0 = N(0, Kr (x) P_t),

Kr the spatial gram with the reference's jitter, dtype_jitter(dtype) times
the mean of its diagonal. The Kronecker products are materialised (state
dim Ns * Dt); a regular time grid keeps its Fills.
"""

import torch

from ..gp import kernels as K
from ..gp.lti_sde import _block_diag, _combine_leaves, _concat, lgssm_components
from ..utils import psd
from ..utils.gaussian import Gaussian
from . import grids
from .separable import Separable


def _kron(A, B):
    """kron on the trailing two axes, broadcasting leading ones."""
    if A.ndim == 2 and B.ndim == 2:
        return torch.kron(A, B)
    return K._batched_kron(A, B)


def lgssm_components_spacetime(kernel, x, dtype, device):
    """Recursive space-time compiler -> (As, offs, Qs, (Hs, hs), x0): a
    Separable directly, a Scaled or Sum of them by recursion (as the
    time-series compiler composes its kernels)."""
    N = grids.n_time(x)
    if isinstance(kernel, K.Scaled):
        As, offs, Qs, (Hs, hs), x0 = lgssm_components_spacetime(kernel.kernel, x, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(kernel.sigma2, dtype=dtype, device=device))
        return As, offs, Qs, (_combine_leaves(lambda H: sigma * H, [Hs], N),
                              _combine_leaves(lambda h: sigma * h, [hs], N)), x0
    if isinstance(kernel, K.Sum):
        parts = [lgssm_components_spacetime(c, x, dtype, device) for c in kernel.kernels]
        leaves = lambda i: [p[i] for p in parts]
        x0 = Gaussian(torch.cat([p[4].mean for p in parts], dim=-1),
                      psd.block_diag([p[4].cov for p in parts]))
        return (_combine_leaves(_block_diag, leaves(0), N), _combine_leaves(_concat, leaves(1), N),
                _combine_leaves(_block_diag, leaves(2), N),
                (_combine_leaves(_concat, [p[3][0] for p in parts], N),
                 _combine_leaves(lambda *hs: sum(hs), [p[3][1] for p in parts], N)), x0)
    if not isinstance(kernel, Separable):
        raise TypeError("spatio-temporal inference requires Separable-based kernels, got "
                        f"{type(kernel).__name__}")
    if not isinstance(x, grids.RectilinearGrid):
        raise TypeError("exact spatio-temporal inference requires a RectilinearGrid")

    As_t, offs_t, Qs_t, (Hs_t, hs_t), x0_t = lgssm_components(kernel.r, x.xr, dtype, device)
    Kr = K.gram(kernel.l, torch.as_tensor(x.xl, device=device))
    eps = psd.dtype_jitter(dtype) * torch.diagonal(Kr).mean()
    Kr = (Kr + eps * torch.eye(Kr.shape[0], dtype=Kr.dtype, device=device)).to(dtype)
    Ns = Kr.shape[0]
    ident = torch.eye(Ns, dtype=dtype, device=device)

    As = _combine_leaves(lambda A: _kron(ident, A), [As_t], N)
    offs = _combine_leaves(lambda a: torch.tile(a, (Ns,)), [offs_t], N)
    Qs = _combine_leaves(lambda Q: _kron(Kr, Q), [Qs_t], N)
    # H_t is a (Dt,) row: the emission matrix is I_Ns (x) H_t, (Ns, Ns * Dt).
    Hs = _combine_leaves(lambda H: _kron(ident, H[..., None, :]), [Hs_t], N)
    hs = _combine_leaves(lambda h: h[..., None].expand(*h.shape, Ns), [hs_t], N)
    x0 = Gaussian(torch.tile(x0_t.mean, (Ns,)), psd.symmetrize(_kron(Kr, x0_t.cov)).to(dtype))
    return As, offs, Qs, (Hs, hs), x0
