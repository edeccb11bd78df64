"""Temporal kernels: their dense grams (the O(N^3) oracle) and LTI-SDE atoms
(temporalgps_tpu/gp/kernels.py).

Matern12 (state dim 1), Matern32 (2), Matern52 (3), Cosine (2), Constant
(1), ApproxPeriodic (2 n_cos), and the combinators Scaled (`sigma2 * k`),
Stretched (`k.stretch(s)`), Sum (`k1 + k2`, the direct sum of the children's
state spaces, composed by gp.lti_sde.lgssm_components) and Product (`k1 *
k2`, the Kronecker product of their states). EQ has its dense gram, the
spatial factor of a space-time `Separable` kernel (space_time/), and no
finite SDE: its SDE functions raise TypeError, as the reference's do.
Hyperparameters are stored as given (Python floats or tensors, which may
require grad); they are cast to the model's dtype and device where the
model is built.

Cosine, Constant and ApproxPeriodic are deterministic: their SDE has no
diffusion (Q = 0), so a sample is a finite sum of basis functions with
Gaussian weights (`det_basis_columns`); `split_deterministic` separates
them from the stochastic summands for the basis engine (ops/basis.py).

Discretisation uses closed forms: for a Matern, F + lam I is nilpotent, so
expm(F dt) = e^{-lam dt} sum_{j<d} (F + lam I)^j dt^j / j!; Cosine and
ApproxPeriodic are 2 x 2 rotations; a Product's transition is the Kronecker
product of its children's (the exponential of a Kronecker sum).
"""

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..utils import psd


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
class Cosine(Kernel):
    """k(t, t') = cos(t - t'), in the gram and the SDE alike (the
    reference's convention; KernelFunctions' CosineKernel is cospi)."""


@dataclasses.dataclass(frozen=True, eq=False)
class Constant(Kernel):
    c: Any  # the variance of the constant function


@dataclasses.dataclass(frozen=True, eq=False)
class ApproxPeriodic(Kernel):
    """The periodic kernel exp(-sin^2(pi tau) / (2 r^2)) (period 1) as
    `n_cos` cosine processes at the harmonics 2 pi j with Bessel-function
    weights (after Benavoli & Corani). Its gram is the exact periodic
    kernel; the truncation error is ~e^-x I_n(x), x = 1 / (4 r^2)."""

    r: Any
    n_cos: int = 7


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


def _as_like(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


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
    if isinstance(k, Cosine):
        return torch.cos(x[:, None] - y[None, :])
    if isinstance(k, Constant):
        return _as_like(k.c, x) * torch.ones_like(_pairwise_dist(x, y))
    if isinstance(k, ApproxPeriodic):
        # The exact periodic kernel.
        tau = x[:, None] - y[None, :]
        return torch.exp(-torch.sin(math.pi * tau) ** 2 / (2.0 * _as_like(k.r, x) ** 2))
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
    raise TypeError(type(k))


def gram_diag(k: Kernel, x):
    """diag(gram(k, x, x)) without the O(N^2) matrix."""
    x = torch.as_tensor(x)
    if isinstance(k, (Matern12, Matern32, Matern52, EQ, Cosine, ApproxPeriodic)):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    if isinstance(k, Constant):
        return _as_like(k.c, x) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
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
    raise TypeError(type(k))


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


def _rotation(omega, dt, dtype, device):
    """expm(omega [[0, -1], [1, 0]] dt): a 2 x 2 rotation, batched over dt."""
    th = omega * torch.as_tensor(dt, dtype=dtype, device=device)
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def _besseli_scaled(n: int, x):
    """e^{-x} I_n(x) on the whole range: the ascending series (positive
    terms, no cancellation; enough terms for a truncation below 1e-12 at the
    switch) up to x_s(n) = max(30, n^2), the Hankel asymptotic expansion
    beyond, as the reference's. Each branch is evaluated on an argument
    clamped to its own side of the switch, so the branch not taken gives no
    inf or NaN that would reach the gradient in x through torch.where."""
    x = torch.as_tensor(x)
    const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    mu = 4.0 * n * n
    x_s = max(30.0, mu / 4.0)
    ks = range(int(x_s / 2.0 + 6.0 * math.sqrt(x_s)) + 10)

    # sum_k (x/2)^(n + 2k) / (k! (n + k)!) e^-x, all terms at once, summed
    # in order (cumsum: the reference's rounding on the CPU).
    x_lo = torch.clamp(x, max=x_s)[..., None]
    log_norm = const([math.lgamma(k + 1) + math.lgamma(n + k + 1) for k in ks])
    series = torch.exp(const([n + 2.0 * k for k in ks]) * torch.log(x_lo / 2.0) - log_norm
                       - x_lo).cumsum(-1)[..., -1]

    # e^{-x} I_n(x) ~ (2 pi x)^{-1/2} sum_k (-1)^k prod_{j<k} (mu - (2j+1)^2) / (k! (8x)^k)
    x_hi = torch.clamp(x, min=x_s)
    ks = range(1, 13)
    terms = torch.cumprod(const([-(mu - (2 * k - 1) ** 2) for k in ks])
                          / (const([8.0 * k for k in ks]) * x_hi[..., None]), dim=-1)
    asym = torch.cat([torch.ones_like(terms[..., :1]), terms], dim=-1).cumsum(-1)[..., -1]
    return torch.where(x <= x_s, series, asym / torch.sqrt(2.0 * math.pi * x_hi))


def _periodic_cov(k, dtype, device):
    """The stationary covariance of an ApproxPeriodic's n_cos harmonics,
    diagonal: (2 - [j = 0]) e^{-x} I_j(x) twice for harmonic j, x = 1 /
    (4 r^2). A Python float r is evaluated on the host (about 20 small ops
    a harmonic), a tensor r where it lies, differentiably."""
    r = k.r if torch.is_tensor(k.r) else torch.tensor(k.r, dtype=torch.float64)
    inv_l2 = 1.0 / (4.0 * r.to(dtype) ** 2)
    w = torch.stack([(2.0 - (j == 0)) * _besseli_scaled(j, inv_l2) for j in range(k.n_cos)])
    return torch.diag_embed(w.repeat_interleave(2)).to(dtype=dtype, device=device)


def has_deterministic_component(k) -> bool:
    """Whether the kernel's SDE has state blocks without diffusion (Cosine,
    Constant, ApproxPeriodic): their information grows without bound along
    the filter, which the covariance-form element algebra cannot carry in
    float32 at large N."""
    if isinstance(k, (Cosine, Constant, ApproxPeriodic)):
        return True
    if isinstance(k, (Scaled, Stretched)):
        return has_deterministic_component(k.kernel)
    if isinstance(k, (Sum, Product)):
        return any(has_deterministic_component(c) for c in k.kernels)
    return False


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
    if isinstance(k, Cosine):
        H = torch.tensor([1.0, 0.0], dtype=dtype, device=device)
        return SDEAtoms(torch.eye(2, dtype=dtype, device=device), H,
                        lambda dt: _rotation(1.0, dt, dtype, device))
    if isinstance(k, Constant):
        P = torch.as_tensor(k.c, dtype=dtype, device=device).reshape(1, 1)
        one = torch.ones((1, 1), dtype=dtype, device=device)

        def transition(dt):
            dt = torch.as_tensor(dt, dtype=dtype, device=device)
            return one.expand(*dt.shape, 1, 1)

        return SDEAtoms(P, torch.ones(1, dtype=dtype, device=device), transition)
    if isinstance(k, ApproxPeriodic):
        H = torch.tensor([1.0, 0.0], dtype=dtype, device=device).repeat(k.n_cos)
        return SDEAtoms(_periodic_cov(k, dtype, device), H, lambda dt: psd.block_diag(
            [_rotation(2.0 * math.pi * j, dt, dtype, device) for j in range(k.n_cos)]))
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
    raise TypeError(f"no SDE representation for {type(k).__name__}")


def _batched_kron(A, B):
    """kron on the trailing two axes, broadcasting the leading ones."""
    ra, ca = A.shape[-2:]
    rb, cb = B.shape[-2:]
    out = A[..., :, None, :, None] * B[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (ra * rb, ca * cb))


def state_dim(k: Kernel) -> int:
    if isinstance(k, (Matern12, Constant)):
        return 1
    if isinstance(k, (Matern32, Cosine)):
        return 2
    if isinstance(k, Matern52):
        return 3
    if isinstance(k, ApproxPeriodic):
        return 2 * k.n_cos
    if isinstance(k, (Scaled, Stretched)):
        return state_dim(k.kernel)
    if isinstance(k, Sum):
        return sum(state_dim(c) for c in k.kernels)
    if isinstance(k, Product):
        return math.prod(state_dim(c) for c in k.kernels)
    raise TypeError(type(k))


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
    if isinstance(k, Cosine):
        return tensor([[0.0, -1.0], [1.0, 0.0]]), 0.0, tensor([1.0, 0.0])
    if isinstance(k, Constant):
        return tensor([[0.0]]), 0.0, tensor([1.0])
    if isinstance(k, ApproxPeriodic):
        # Cosine SDEs at the harmonics 2 pi j, j < n_cos; no diffusion (the
        # harmonics' weights are in P_inf, sde_atoms).
        Fc, _, Hc = to_sde_matrices(Cosine(), dtype, device)
        return (psd.block_diag([2.0 * math.pi * j * Fc for j in range(k.n_cos)]), 0.0,
                Hc.repeat(k.n_cos))
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
    raise TypeError(type(k))


# ---------------------------------------------------------------------------
# The deterministic summands as basis functions (the basis engine's front end)
# ---------------------------------------------------------------------------

def split_deterministic(k):
    """(stochastic summands, deterministic summands) of a kernel, two lists.
    A deterministic summand (Cosine, Constant, ApproxPeriodic, no diffusion)
    is a finite set of basis functions with Gaussian weights, f(t) = H
    expm(F t) w, w ~ N(0, P_inf), which the basis engine marginalises
    against the reduced stochastic model. Scaled and Stretched distribute
    over the split. A Product is deterministic only when all its factors
    are: with a stochastic factor its Q = Q_stoch (x) P_det is positive
    definite, and it stays on the stochastic side."""
    if isinstance(k, Sum):
        stoch, det = [], []
        for c in k.kernels:
            s, d = split_deterministic(c)
            stoch += s
            det += d
        return stoch, det
    if isinstance(k, (Scaled, Stretched)):
        s, d = split_deterministic(k.kernel)
        wrap = ((lambda c: Scaled(c, k.sigma2)) if isinstance(k, Scaled)
                else (lambda c: Stretched(c, k.s)))
        return [wrap(c) for c in s], [wrap(c) for c in d]
    if isinstance(k, (Cosine, Constant, ApproxPeriodic)):
        return [], [k]
    if isinstance(k, Product):
        if all(has_deterministic_component(c) for c in k.kernels):
            return [], [k]
        return [k], []
    return [k], []


def det_basis_columns(k: Kernel, tau, dtype=torch.float64, device="cuda"):
    """(M, P0): the basis matrix M (N, d) and weight prior P0 (d, d) of a
    deterministic kernel, f(t) = M(t) w, w ~ N(0, P0), M(t) = H expm(F tau),
    tau = t - t0 (N,). The rotations preserve P_inf, so M(t) P0 M(t')^T is
    the kernel's gram for any t0. Closed forms per leaf: an ApproxPeriodic
    gives (N, 2) columns per harmonic, no (N, d, d) transition."""
    tau = torch.as_tensor(tau, dtype=dtype, device=device)
    if isinstance(k, Cosine):
        return (torch.stack([torch.cos(tau), -torch.sin(tau)], dim=-1),
                torch.eye(2, dtype=dtype, device=device))
    if isinstance(k, Constant):
        return (torch.ones(*tau.shape, 1, dtype=dtype, device=device),
                torch.as_tensor(k.c, dtype=dtype, device=device).reshape(1, 1))
    if isinstance(k, ApproxPeriodic):
        # Columns cos(2 pi j tau), -sin(2 pi j tau), harmonic by harmonic.
        th = tau[..., None] * (2.0 * math.pi * torch.arange(k.n_cos, dtype=dtype, device=device))
        M = torch.stack([torch.cos(th), -torch.sin(th)], dim=-1).reshape(*tau.shape, -1)
        return M, _periodic_cov(k, dtype, device)
    if isinstance(k, Scaled):
        M, P0 = det_basis_columns(k.kernel, tau, dtype, device)
        return torch.sqrt(torch.as_tensor(k.sigma2, dtype=dtype, device=device)) * M, P0
    if isinstance(k, Stretched):
        s = torch.as_tensor(k.s, dtype=dtype, device=device)
        return det_basis_columns(k.kernel, s * tau, dtype, device)
    if isinstance(k, Product):
        M, P0 = det_basis_columns(k.kernels[0], tau, dtype, device)
        for c in k.kernels[1:]:
            Mc, Pc = det_basis_columns(c, tau, dtype, device)
            M = (M[..., :, None] * Mc[..., None, :]).reshape(*M.shape[:-1], -1)
            P0 = torch.kron(P0, Pc)
        return M, P0
    raise TypeError(f"{type(k).__name__} is not a deterministic kernel")
