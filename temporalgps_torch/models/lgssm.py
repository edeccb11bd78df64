"""LGSSM — model container and its logpdf (temporalgps_tpu/models/lgssm.py).

Engines ported:
  * "sequential" — a Python loop over time of ops/lgc steps; the ground
    truth, for any model the compiler builds (Fill or per-step parameters).
  * "block"      — the block-parallel filter of ops/block.py on the
    hand-written kernels (CUDA) or their plain versions (CPU).
"""

import dataclasses
import itertools
from typing import Any

import torch

from ..ops import lgc
from ..utils.fill import is_fill
from .gauss_markov import GaussMarkov


@dataclasses.dataclass(frozen=True, eq=False)
class LGSSM:
    trans: GaussMarkov
    emis: Any  # ScalarEmissions

    def __len__(self):
        return len(self.trans)

    @property
    def latent_dim(self) -> int:
        return self.trans.dim

    @property
    def dtype(self):
        return self.trans.x0.mean.dtype

    @property
    def device(self):
        return self.trans.x0.mean.device


def _resolve_engine(engine, model=None):
    """`None` picks "block" for a model on a CUDA device that the fused
    kernels take, and "sequential" everywhere else (the reference picks
    "block" on the TPU)."""
    if engine is not None:
        return engine
    if model is not None and model.device.type == "cuda":
        from ..ops import block

        if block._pallas_supported(model):
            return "block"
    return "sequential"


_NOT_PORTED = {
    "parallel": "ROADMAP Queue 1 item 10",
    "sqrt": "ROADMAP Queue 1 item 10",
    "lti": "ROADMAP Queue 1 item 10",
    "steady": "ROADMAP Queue 1 item 8",
}


def logpdf(model: LGSSM, y, *, engine=None, fused=None, n_blocks=None):
    """Log marginal likelihood via the Kalman filter. For engine="block",
    `fused=False` runs the plain PyTorch blocked schedule instead of the
    kernels, and `n_blocks` overrides the block count."""
    engine = _resolve_engine(engine, model)
    y = torch.as_tensor(y, dtype=model.dtype, device=model.device)
    if engine == "block":
        from ..ops import block

        return block.logpdf(model, y, n_blocks=n_blocks, fused=fused)
    if engine == "sequential":
        return _logpdf_sequential(model, y)
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet ({_NOT_PORTED[engine]})"
        )
    raise ValueError(f"unknown engine {engine!r}")


def _steps(leaf, N):
    """Per-step values of a parameter leaf."""
    return itertools.repeat(leaf.value, N) if is_fill(leaf) else leaf.unbind(0)


def _logpdf_sequential(model: LGSSM, y):
    if not model.trans.forward:
        raise NotImplementedError(
            "reverse-ordered models are not ported yet (ROADMAP Queue 1 item 6)"
        )
    t, e = model.trans, model.emis
    N = len(model)
    x = t.x0
    lmls = []
    per_step = zip(
        _steps(t.As, N), _steps(t.offs, N), _steps(t.Qs, N),
        _steps(e.H, N), _steps(e.h, N), _steps(e.s, N), y.unbind(0),
    )
    for A, a, Q, H, h, s, yt in per_step:
        x, lml = lgc.posterior_and_lml_scalar(lgc.predict(x, A, a, Q), H, h, s, yt)
        lmls.append(lml)
    return torch.stack(lmls).sum()
