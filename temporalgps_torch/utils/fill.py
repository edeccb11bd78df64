"""Fill — a time-invariant per-step parameter: one value and a length.

A RegularSpacing model has one shared (A, Q) for all N steps; a Fill keeps
that O(1) instead of materialising N copies (temporalgps_tpu/utils/fill.py).
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Fill:
    value: torch.Tensor
    N: int

    def __len__(self):
        return self.N


def is_fill(x) -> bool:
    return isinstance(x, Fill)


def tmaterialize(leaf):
    """A per-step leaf with a concrete leading time axis: a Fill becomes an
    (N, ...) broadcast view of its value; a tensor is returned as it is."""
    if is_fill(leaf):
        return leaf.value.expand((leaf.N,) + tuple(leaf.value.shape))
    return leaf
