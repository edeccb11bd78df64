"""GaussMarkov — the latent Markov chain (temporalgps_tpu/models/gauss_markov.py):

    x[0] ~ x0,    x[t] = A[t] x[t-1] + a[t] + eps[t],   eps[t] ~ N(0, Q[t])

As, offs, Qs are (N, ...) tensors or Fills. `forward=False` is the reverse
ordering of a smoother's posterior chain, which models.lgssm.posterior
builds: step t emits before its transition, and x0 is the state at the last
step. `det_blocks` marks a chain with state blocks of no process noise (a
kernel with a Cosine, Constant or ApproxPeriodic summand): the filter's
information grows without bound along them, and the steady engine refuses
it (ops/steady.py). Every rebuild of a model from another carries it.
"""

import dataclasses
from typing import Any

from ..utils.fill import is_fill
from ..utils.gaussian import Gaussian


@dataclasses.dataclass(frozen=True, eq=False)
class GaussMarkov:
    As: Any    # (N, D, D) or Fill((D, D))
    offs: Any  # (N, D) or Fill((D,))
    Qs: Any    # (N, D, D) or Fill((D, D))
    x0: Gaussian
    forward: bool = True
    det_blocks: bool = False

    def __len__(self):
        return self.As.N if is_fill(self.As) else self.As.shape[0]

    @property
    def dim(self) -> int:
        return self.x0.dim
