"""Hyperparameter learning (temporalgps_tpu/learning.py): positive-constrained
parameters, forward-mode value-and-gradient functions, and fit loops on
torch.optim (Adam, or L-BFGS with a strong-Wolfe line search).

Parameters are a tensor or a pytree (dict, list, tuple) of tensors.

`value_and_grad_fwd_lgssm` is the training path: the primal filter and the k
tangent filters share one pass through the block engine's forward-mode
kernels (ops/block.logpdf_fwd_grad), for Fill models with D <= 3; other
models take the forward mode of the general block schedule. It needs the
derivative of every model
leaf along every parameter. `LGSSM` and `Fill` are not pytrees that
torch.func knows, so the model is unpacked: one torch.func.jacfwd over a
function that returns the leaves (A, a, Q, H, h, s, m0, P0) of
`model_fn(p)` gives all k tangents at once, and the tangent models are
rebuilt from its slices with the model's own structure.
"""

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .models.lgssm import LGSSM
from .models.missings import logpdf_with_missings
from .ops import block
from .utils.fill import Fill, is_fill
from .utils.gaussian import Gaussian


def positive(x, *, device="cuda"):
    """Initial value of a positive-constrained parameter (stored as its log),
    on the card unless the caller asks for the CPU."""
    return torch.log(torch.as_tensor(x, dtype=torch.float64, device=device))


def constrained(log_x):
    return torch.exp(log_x)


class FitResult(NamedTuple):
    params: Any
    losses: torch.Tensor


def _adam(leaves):
    return torch.optim.Adam(leaves, lr=1e-1)


def fit(objective: Callable, params, *, optimizer=None, steps: int = 100,
        has_grad: bool = False) -> FitResult:
    """Minimise `objective(params)` with a torch.optim optimiser; returns the
    optimised params (same structure) and the loss at the start of each step.

    `optimizer` makes the optimiser from the list of parameter tensors
    (default Adam with lr 1e-1). With `has_grad`, `objective` returns (loss,
    gradient pytree) itself, e.g. a negated `value_and_grad_fwd_lgssm`;
    otherwise the gradient is autograd's."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [torch.as_tensor(t).detach().clone().requires_grad_(not has_grad) for t in leaves]
    opt = (optimizer or _adam)(leaves)

    def closure():
        opt.zero_grad()
        if has_grad:
            loss, grads = objective(pytree.tree_unflatten(leaves, spec))
            for leaf, grad in zip(leaves, pytree.tree_leaves(grads)):
                leaf.grad = grad.detach().to(leaf).reshape(leaf.shape)
        else:
            loss = objective(pytree.tree_unflatten(leaves, spec))
            loss.backward()
        return loss.detach()

    losses = [opt.step(closure) for _ in range(steps)]
    fitted = pytree.tree_unflatten([t.detach() for t in leaves], spec)
    return FitResult(fitted, torch.stack(losses))


def fit_lbfgs(objective, params, *, steps: int = 50, has_grad: bool = False) -> FitResult:
    """L-BFGS with a strong-Wolfe line search, one iteration a step (the
    reference's is optax's L-BFGS with a backtracking search: the iterates
    differ, the optimum does not)."""
    def lbfgs(leaves):
        # max_eval bounds the line search too (its default, 5/4 of max_iter,
        # would leave it no evaluation at all).
        return torch.optim.LBFGS(leaves, max_iter=1, max_eval=25,
                                 line_search_fn="strong_wolfe")

    return fit(objective, params, optimizer=lbfgs, steps=steps, has_grad=has_grad)


def value_and_grad_fwd(f):
    """Forward-mode value_and_grad for objectives with few parameters: one
    batched JVP pass (torch.func.jacfwd) over all parameters, no residuals
    and no backward pass.

    f: params pytree -> scalar. Returns fn: params -> (value, grad pytree)."""
    def vg(params, *args):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [torch.as_tensor(t).detach() for t in leaves]
        sizes = [t.numel() for t in leaves]

        def unravel(flat):
            parts = torch.split(flat, sizes)
            return pytree.tree_unflatten(
                [part.reshape(t.shape) for part, t in zip(parts, leaves)], spec)

        def g(flat):
            value = f(unravel(flat), *args)
            return value, value

        flat = torch.cat([t.reshape(-1) for t in leaves])
        grad, value = torch.func.jacfwd(g, has_aux=True)(flat)
        return value, unravel(grad)

    return vg


_PER_STEP = (("trans", "As"), ("trans", "offs"), ("trans", "Qs"),
             ("emis", "H"), ("emis", "h"), ("emis", "s"))


def _leaves(model):
    """The tensors of a model: the per-step leaves (A, a, Q, H, h, s), a
    Fill by its value, then the prior's (m0, P0)."""
    per_step = [getattr(getattr(model, part), name) for part, name in _PER_STEP]
    x0 = model.trans.x0
    return (*(leaf.value if is_fill(leaf) else leaf for leaf in per_step), x0.mean, x0.cov)


def _model_like(model, leaves):
    """A model of `model`'s structure (Fill where it has a Fill) over other
    leaf tensors, e.g. their derivatives along one parameter."""
    new = {"trans": {"x0": Gaussian(*leaves[6:])}, "emis": {}}
    for (part, name), leaf in zip(_PER_STEP, leaves):
        old = getattr(getattr(model, part), name)
        new[part][name] = Fill(leaf, old.N) if is_fill(old) else leaf
    return LGSSM(dataclasses.replace(model.trans, **new["trans"]),
                 dataclasses.replace(model.emis, **new["emis"]))


def _model_and_tangents(model_fn, flat):
    """(model, [k tangent models]) of `model_fn` at `flat`: one jacfwd over
    the model's leaves, sliced per parameter. Each tangent model has the
    model's own structure, as jax.jvp of `model_fn` would give it."""
    built = []

    def leaves_fn(p):
        built.append(model_fn(p))
        leaves = _leaves(built[-1])
        return leaves, leaves

    jac, leaves = torch.func.jacfwd(leaves_fn, has_aux=True)(flat)
    per_tangent = [J.movedim(-1, 0).unbind(0) for J in jac]
    tangents = [_model_like(built[-1], t_leaves) for t_leaves in zip(*per_tangent)]
    return _model_like(built[-1], leaves), tangents


def value_and_grad_fwd_lgssm(model_fn, y, *, n_blocks=None, fallback=None):
    """Forward-mode value_and_grad of `p -> logpdf(model_fn(p), y)` in one
    pass of the forward-mode kernels (ops/block.logpdf_fwd_grad): about
    (1+k) primal filters, no residuals.

    model_fn: flat parameter tensor -> forward-ordered scalar-emission LGSSM.
    NaNs in y are missing observations. Fill parameters with D <= 3 (the
    Matern learning configuration on RegularSpacing) run K4-K6.

    A model the kernels do not take (`block._fwd_grad_supported`: per-step
    parameters such as irregular times, per-step noise, D > 3) goes to
    `value_and_grad_fwd` of `fallback` (p -> logpdf) where the caller gave
    one, and otherwise of the block engine's plain general schedule (the
    lane path for D <= 3, the matrix path beyond), on the model's device, as
    the reference runs a vmapped JVP of its XLA schedule there. The route is
    chosen by `_fwd_grad_supported` before anything runs.

    Returns fn: params -> (value, grad), grad with params' dtype and device."""
    y_cache = {}

    def y_on(model):
        """y as the model's dtype on its device, carried there once."""
        key = (model.dtype, model.device)
        if key not in y_cache:
            y_cache[key] = torch.as_tensor(y, dtype=model.dtype, device=model.device)
        return y_cache[key]

    def plain_logpdf(p):
        model = model_fn(p)
        return logpdf_with_missings(model, y_on(model), engine="block", fused=False,
                                    n_blocks=n_blocks)

    def vg(params):
        flat = torch.as_tensor(params).detach()
        model, tangents = _model_and_tangents(model_fn, flat)
        if block._fwd_grad_supported(model, tangents):
            value, grad = block.logpdf_fwd_grad(model, y_on(model), tangents, n_blocks=n_blocks)
            return value, grad.to(flat)
        return value_and_grad_fwd(fallback or plain_logpdf)(flat)

    return vg


def value_and_grad_fisher(model_fn, y, *, n_blocks=None, engine="parallel"):
    """The closed-form Fisher/EM-identity gradient of the reference; it needs
    ops/fisher.py, which is not ported yet."""
    raise NotImplementedError(
        "value_and_grad_fisher is not ported yet (ROADMAP Queue 1 item 10: "
        "ops/fisher.py)"
    )
