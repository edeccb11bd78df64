"""Temporal kernels and their LTI-SDE atoms (temporalgps_tpu/gp/kernels.py).

Ported: Matern12 (state dim 1), Matern32 (2), Matern52 (3), and the
combinators Scaled (`sigma2 * k`) and Stretched (`k.stretch(s)`).
Hyperparameters are stored as given (Python floats or tensors, which may
require grad); they are cast to the model's dtype and device where the
model is built.

Discretisation uses the Matern closed form: F + lam I is nilpotent, so
expm(F dt) = e^{-lam dt} sum_{j<d} (F + lam I)^j dt^j / j!.
"""

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


class Kernel:
    """Operator sugar: `c * k` scales, `k.stretch(s)` rescales time."""

    def __add__(self, other):
        raise NotImplementedError(
            "Sum kernels are not ported yet (ROADMAP Queue 1 item 2)"
        )

    def __mul__(self, other):
        if isinstance(other, Kernel):
            raise NotImplementedError(
                "Product kernels are not ported yet (ROADMAP Queue 1 item 2)"
            )
        return Scaled(self, other)

    def __rmul__(self, other):
        return Scaled(self, other)

    def stretch(self, s):
        """k(s x, s y)."""
        return Stretched(self, s)


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
class Scaled(Kernel):
    kernel: Any
    sigma2: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Stretched(Kernel):
    kernel: Any
    s: Any


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
    raise NotImplementedError(
        f"{type(k).__name__} has no SDE in the port yet (ROADMAP Queue 1 items 2 and 9)"
    )
