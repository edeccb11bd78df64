"""Temporal kernels: their dense grams (the O(N^3) oracle) and LTI-SDE atoms
(temporalgps_tpu/gp/kernels.py).

Ported: Matern12 (state dim 1), Matern32 (2), Matern52 (3), and the
combinators Scaled (`sigma2 * k`), Stretched (`k.stretch(s)`), Sum
(`k1 + k2`, the direct sum of the children's state spaces, composed by
gp.lti_sde.lgssm_components) and Product (`k1 * k2`, the Kronecker product
of their states). EQ has its dense gram, the spatial factor of a space-time
`Separable` kernel (space_time/); its SDE, Cosine, Constant and
ApproxPeriodic wait for ROADMAP Queue 1 item 9. Hyperparameters are stored as
given (Python floats or tensors, which may require grad); they are cast to
the model's dtype and device where the model is built.

Discretisation uses closed forms: for a Matern, F + lam I is nilpotent, so
expm(F dt) = e^{-lam dt} sum_{j<d} (F + lam I)^j dt^j / j!; a Product's
transition is the Kronecker product of its children's (the exponential of a
Kronecker sum).
"""

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..utils import psd

_NOT_PORTED = ("is not ported yet: Cosine, Constant, ApproxPeriodic and EQ's SDE wait for "
               "ROADMAP Queue 1 item 9")


class Kernel:
    """Operator sugar: `k1 + k2` sums, `k1 * k2` multiplies, `c * k` scales,
    `k.stretch(s)` rescales time."""

    def __add__(self, other):
        return Sum(_as_kernel_tuple(self, Sum) + _as_kernel_tuple(other, Sum))

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return Product(_as_kernel_tuple(self, Product) + _as_kernel_tuple(other, Product))
        return Scaled(self, other)

    def __rmul__(self, other):
        return Scaled(self, other)

    def stretch(self, s):
        """k(s x, s y)."""
        return Stretched(self, s)


def _as_kernel_tuple(k, cls):
    return k.kernels if isinstance(k, cls) else (k,)


@dataclasses.dataclass(frozen=True, eq=False)
class Matern12(Kernel):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Matern32(Kernel):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Matern52(Kernel):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class EQ(Kernel):
    """The squared-exponential kernel exp(-|x - y|^2 / 2), spatial use only:
    it has no finite SDE."""


@dataclasses.dataclass(frozen=True, eq=False)
class Scaled(Kernel):
    kernel: Any
    sigma2: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Stretched(Kernel):
    kernel: Any
    s: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Sum(Kernel):
    kernels: Tuple


@dataclasses.dataclass(frozen=True, eq=False)
class Product(Kernel):
    kernels: Tuple


# ---------------------------------------------------------------------------
# Dense grams: the O(N^3) oracle (gp/dense.py)
# ---------------------------------------------------------------------------

def _pairwise_dist(x, y):
    """|x_i - y_j| of (N,) times, or the Euclidean distance of (N, d) points."""
    d = x[:, None] - y[None, :]
    if d.ndim == 2:
        return d.abs()
    return torch.sqrt(torch.clamp((d * d).sum(-1), min=0.0))


def gram(k: Kernel, x, y=None):
    """Dense kernel matrix k(x, y)."""
    x = torch.as_tensor(x)
    y = x if y is None else torch.as_tensor(y)
    if isinstance(k, Matern12):
        return torch.exp(-_pairwise_dist(x, y))
    if isinstance(k, Matern32):
        tau = _pairwise_dist(x, y) * math.sqrt(3.0)
        return (1.0 + tau) * torch.exp(-tau)
    if isinstance(k, Matern52):
        tau = _pairwise_dist(x, y) * math.sqrt(5.0)
        return (1.0 + tau + tau * tau / 3.0) * torch.exp(-tau)
    if isinstance(k, EQ):
        tau = _pairwise_dist(x, y)
        return torch.exp(-0.5 * tau * tau)
    if isinstance(k, Scaled):
        return k.sigma2 * gram(k.kernel, x, y)
    if isinstance(k, Stretched):
        return gram(k.kernel, k.s * x, k.s * y)
    if isinstance(k, Sum):
        return sum(gram(c, x, y) for c in k.kernels)
    if isinstance(k, Product):
        out = gram(k.kernels[0], x, y)
        for c in k.kernels[1:]:
            out = out * gram(c, x, y)
        return out
    raise NotImplementedError(f"the gram of {type(k).__name__} {_NOT_PORTED}")


def gram_diag(k: Kernel, x):
    """diag(gram(k, x, x)) without the O(N^2) matrix."""
    x = torch.as_tensor(x)
    if isinstance(k, (Matern12, Matern32, Matern52, EQ)):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    if isinstance(k, Scaled):
        return k.sigma2 * gram_diag(k.kernel, x)
    if isinstance(k, Stretched):
        return gram_diag(k.kernel, k.s * x)
    if isinstance(k, Sum):
        return sum(gram_diag(c, x) for c in k.kernels)
    if isinstance(k, Product):
        out = gram_diag(k.kernels[0], x)
        for c in k.kernels[1:]:
            out = out * gram_diag(c, x)
        return out
    raise NotImplementedError(f"the gram of {type(k).__name__} {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# LTI-SDE atoms: (P_inf, H, transition(dt)) with closed-form discretisation
# ---------------------------------------------------------------------------


class SDEAtoms(NamedTuple):
    """Stationary covariance P_inf (D, D), emission row H (D,), and the exact
    discretisation transition(dt) -> (..., D, D). With Q(dt) = P_inf -
    A P_inf A^T they determine the kernel's Gauss-Markov chain."""

    P_inf: torch.Tensor
    H: torch.Tensor
    transition: Callable


def _matern_atoms(lam: float, d: int, P_inf, dtype, device) -> SDEAtoms:
    F = torch.zeros((d, d), dtype=dtype, device=device)
    for i in range(d - 1):
        F[i, i + 1] = 1.0
    for j in range(d):
        F[d - 1, j] = -math.comb(d, j) * lam ** (d - j)
    Nmat = F + lam * torch.eye(d, dtype=dtype, device=device)
    powers = [torch.eye(d, dtype=dtype, device=device)]
    for _ in range(d - 1):
        powers.append(powers[-1] @ Nmat)

    def transition(dt):
        dtb = torch.as_tensor(dt, dtype=dtype, device=device)[..., None, None]
        acc = powers[0] + torch.zeros_like(dtb)
        fact = 1.0
        for j in range(1, d):
            fact *= j
            acc = acc + powers[j] * (dtb**j / fact)
        return torch.exp(-lam * dtb) * acc

    H = torch.zeros(d, dtype=dtype, device=device)
    H[0] = 1.0
    return SDEAtoms(torch.tensor(P_inf, dtype=dtype, device=device), H, transition)


def sde_atoms(k: Kernel, dtype=torch.float64, device="cuda") -> SDEAtoms:
    """Recursive SDE construction (standard Matern state-space results,
    Sarkka & Solin, Applied SDEs, ch. 12)."""
    if isinstance(k, Matern12):
        return _matern_atoms(1.0, 1, [[1.0]], dtype, device)
    if isinstance(k, Matern32):
        lam = math.sqrt(3.0)
        return _matern_atoms(lam, 2, [[1.0, 0.0], [0.0, lam**2]], dtype, device)
    if isinstance(k, Matern52):
        lam = math.sqrt(5.0)
        kappa = lam**2 / 3.0
        P = [[1.0, 0.0, -kappa], [0.0, kappa, 0.0], [-kappa, 0.0, lam**4]]
        return _matern_atoms(lam, 3, P, dtype, device)
    if isinstance(k, Scaled):
        child = sde_atoms(k.kernel, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(k.sigma2, dtype=dtype, device=device))
        return SDEAtoms(child.P_inf, sigma * child.H, child.transition)
    if isinstance(k, Stretched):
        child = sde_atoms(k.kernel, dtype, device)
        s = torch.as_tensor(k.s, dtype=dtype, device=device)
        return SDEAtoms(child.P_inf, child.H, lambda dt: child.transition(s * dt))
    if isinstance(k, Product):
        children = [sde_atoms(c, dtype, device) for c in k.kernels]

        def transition(dt):
            A = children[0].transition(dt)
            for c in children[1:]:
                A = _batched_kron(A, c.transition(dt))
            return A

        P, H = children[0].P_inf, children[0].H
        for c in children[1:]:
            P = _batched_kron(P, c.P_inf)
            H = _batched_kron(H[None], c.H[None])[0]
        return SDEAtoms(P, H, transition)
    if isinstance(k, Sum):
        raise TypeError(
            "Sum kernels are combined at the lgssm_components level "
            "(block-diagonal direct sum), as in the reference"
        )
    raise NotImplementedError(f"the SDE of {type(k).__name__} {_NOT_PORTED}")


def _batched_kron(A, B):
    """kron on the trailing two axes, broadcasting the leading ones."""
    ra, ca = A.shape[-2:]
    rb, cb = B.shape[-2:]
    out = A[..., :, None, :, None] * B[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (ra * rb, ca * cb))


def state_dim(k: Kernel) -> int:
    if isinstance(k, Matern12):
        return 1
    if isinstance(k, Matern32):
        return 2
    if isinstance(k, Matern52):
        return 3
    if isinstance(k, (Scaled, Stretched)):
        return state_dim(k.kernel)
    if isinstance(k, Sum):
        return sum(state_dim(c) for c in k.kernels)
    if isinstance(k, Product):
        return math.prod(state_dim(c) for c in k.kernels)
    raise NotImplementedError(f"the SDE of {type(k).__name__} {_NOT_PORTED}")


def to_sde_matrices(k: Kernel, dtype=torch.float64, device="cuda"):
    """(F, q, H) of the continuous-time SDE, for parity with the reference's
    `to_sde_matrices`; the runtime uses the closed-form transitions instead.
    A Sum gives the direct sum: block-diagonal F, concatenated H, and a tuple
    of its summands' white-noise intensities q."""
    tensor = lambda v: torch.tensor(v, dtype=dtype, device=device)
    if isinstance(k, Matern12):
        return tensor([[-1.0]]), 2.0, tensor([1.0])
    if isinstance(k, Matern32):
        lam = math.sqrt(3.0)
        return tensor([[0.0, 1.0], [-(lam**2), -2 * lam]]), 4 * lam**3, tensor([1.0, 0.0])
    if isinstance(k, Matern52):
        lam = math.sqrt(5.0)
        F = tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-(lam**3), -3 * lam**2, -3 * lam]])
        # (2 lam)^5 (2!)^2 / 4! = 16 lam^5 / 3, the q of F P_inf + P_inf F^T +
        # q L L^T = 0, as in the reference.
        return F, 16 * lam**5 / 3.0, tensor([1.0, 0.0, 0.0])
    if isinstance(k, Scaled):
        F, q, H = to_sde_matrices(k.kernel, dtype, device)
        sigma = torch.sqrt(torch.as_tensor(k.sigma2, dtype=dtype, device=device))
        return F, k.sigma2 * q, sigma * H
    if isinstance(k, Stretched):
        F, q, H = to_sde_matrices(k.kernel, dtype, device)
        return F * k.s, q, H
    if isinstance(k, Product):
        # F1 (+) F2 (Kronecker sum), q1 q2, H1 (x) H2.
        F, q, H = to_sde_matrices(k.kernels[0], dtype, device)
        for c in k.kernels[1:]:
            Fc, qc, Hc = to_sde_matrices(c, dtype, device)
            eye = lambda n: torch.eye(n, dtype=dtype, device=device)
            F = (_batched_kron(F, eye(Fc.shape[0])) + _batched_kron(eye(F.shape[0]), Fc))
            q = q * qc
            H = _batched_kron(H[None], Hc[None])[0]
        return F, q, H
    if isinstance(k, Sum):
        parts = [to_sde_matrices(c, dtype, device) for c in k.kernels]
        return (psd.block_diag([p[0] for p in parts]), tuple(p[1] for p in parts),
                torch.cat([p[2] for p in parts]))
    raise NotImplementedError(f"the SDE of {type(k).__name__} {_NOT_PORTED}")
