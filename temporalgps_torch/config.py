"""Numerical constants, the same values as temporalgps_tpu/config.py.

  - DEFAULT_NOISE 1e-12: observation noise of a FiniteLTISDE built without one.
  - IDENT_EPS 1e-12: identity jitter.
  - POSTERIOR_JITTER 1e-10: jitter on covariances inverted by the smoother.
  - LARGE_VAR 1e15: observation variance that stands in for a missing
    observation (and for the padding steps of the block engine).

There is no global precision switch: dtypes are explicit per model
(gp.lti_sde.ArrayStorage).
"""

DEFAULT_NOISE = 1e-12
IDENT_EPS = 1e-12
POSTERIOR_JITTER = 1e-10
LARGE_VAR = 1e15
